"""Model building blocks of the port."""

from .dense import FlaxDense
from .layer_norm import LayerNorm
from .msa_attention import (EvoformerBlock, MSAColumnAttention,
                            MSARowAttentionWithPairBias, MSATransition,
                            OuterProductMean)
from .multihead_attention import (CrossMultiheadAttention,
                                  SelfMultiheadAttention)
from .rotary import apply_rotary, apply_rotary_qk, rotary_cos_sin
from .structure_module import (BackboneUpdate, InvariantPointAttention,
                               StructureModule, StructureModuleLayer)
from .transformer_decoder import TransformerDecoder, TransformerDecoderLayer
from .triangle_attention import (EvoformerPairBlock, PairTransition,
                                 TriangleAttention, TriangleMultiplication,
                                 group_flash_attention)
from .transformer_encoder import (RelativePositionBias, TransformerEncoder,
                                  TransformerEncoderLayer, make_rp_bucket,
                                  relative_position_bucket)

__all__ = [
    "BackboneUpdate", "CrossMultiheadAttention", "EvoformerBlock",
    "EvoformerPairBlock", "FlaxDense", "InvariantPointAttention",
    "LayerNorm", "MSAColumnAttention", "MSARowAttentionWithPairBias",
    "MSATransition", "OuterProductMean", "PairTransition",
    "RelativePositionBias", "SelfMultiheadAttention", "StructureModule",
    "StructureModuleLayer", "TransformerDecoder",
    "TransformerDecoderLayer", "TransformerEncoder",
    "TransformerEncoderLayer", "TriangleAttention", "TriangleMultiplication",
    "apply_rotary", "apply_rotary_qk", "group_flash_attention",
    "make_rp_bucket", "relative_position_bucket", "rotary_cos_sin",
]
