"""Model building blocks of the port."""

from .layer_norm import LayerNorm
from .multihead_attention import SelfMultiheadAttention
from .rotary import apply_rotary, apply_rotary_qk, rotary_cos_sin
from .transformer_decoder import TransformerDecoder, TransformerDecoderLayer

__all__ = [
    "LayerNorm", "SelfMultiheadAttention", "TransformerDecoder",
    "TransformerDecoderLayer", "apply_rotary", "apply_rotary_qk",
    "rotary_cos_sin",
]
