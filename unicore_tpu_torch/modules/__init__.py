"""Model building blocks of the port."""

from .layer_norm import LayerNorm
from .multihead_attention import SelfMultiheadAttention
from .rotary import apply_rotary, apply_rotary_qk, rotary_cos_sin
from .transformer_decoder import TransformerDecoder, TransformerDecoderLayer
from .transformer_encoder import (RelativePositionBias, TransformerEncoder,
                                  TransformerEncoderLayer, make_rp_bucket,
                                  relative_position_bucket)

__all__ = [
    "LayerNorm", "RelativePositionBias", "SelfMultiheadAttention",
    "TransformerDecoder", "TransformerDecoderLayer", "TransformerEncoder",
    "TransformerEncoderLayer", "apply_rotary", "apply_rotary_qk",
    "make_rp_bucket", "relative_position_bucket", "rotary_cos_sin",
]
