"""Self-attention-only transformer decoder (counterpart of
``TransformerDecoderLayer``/``TransformerDecoder`` in
``unicore_tpu/modules/transformer_decoder.py``), pre-LN, causal.

What the decoder LM of the serve path uses: ``emb_layer_norm``, the
padding-mask multiply, the layer stack, ``final_layer_norm``.  Dropout is
0 at serve time, so the port has none yet; cross-attention, post-LN and
the relative-position bias arrive with later slices (the JAX decoder
refuses to decode with the relative-position bias anyway).
"""

from torch import nn

from ..utils import get_activation_fn
from .layer_norm import LayerNorm
from .multihead_attention import SelfMultiheadAttention


class TransformerDecoderLayer(nn.Module):
    def __init__(self, embed_dim=768, ffn_embed_dim=3072,
                 attention_heads=8, activation_fn="gelu", rotary=False):
        super().__init__()
        self.act = get_activation_fn(activation_fn)
        self.self_attn_layer_norm = LayerNorm(embed_dim)
        self.self_attn = SelfMultiheadAttention(embed_dim, attention_heads,
                                                rotary=rotary)
        self.final_layer_norm = LayerNorm(embed_dim)
        self.fc1 = nn.Linear(embed_dim, ffn_embed_dim)
        self.fc2 = nn.Linear(ffn_embed_dim, embed_dim)

    def forward(self, x, padding_mask=None, positions=None, paged=None,
                kv=None):
        residual = x
        x = self.self_attn(
            self.self_attn_layer_norm(x),
            key_padding_mask=None if paged is not None else padding_mask,
            causal=True, positions=positions, paged=paged, kv=kv,
        )
        x = residual + x
        residual = x
        x = self.fc2(self.act(self.fc1(self.final_layer_norm(x))))
        return residual + x


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layers=6, embed_dim=768, ffn_embed_dim=3072,
                 attention_heads=8, activation_fn="gelu", rotary=False):
        super().__init__()
        self.emb_layer_norm = LayerNorm(embed_dim)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(embed_dim, ffn_embed_dim,
                                    attention_heads, activation_fn, rotary)
            for _ in range(decoder_layers)
        )
        self.final_layer_norm = LayerNorm(embed_dim)

    def forward(self, emb, padding_mask=None, positions=None, paged=None):
        """``paged`` (a :class:`~unicore_tpu_torch.serve.attention.
        PagedMeta`) carries one ``(k_pages, v_pages)`` pair per layer."""
        x = self.emb_layer_norm(emb)
        if padding_mask is not None:
            x = x * (1 - padding_mask[..., None].to(x.dtype))
        for i, layer in enumerate(self.layers):
            kv = None if paged is None else paged.kv_pages[i]
            x = layer(x, padding_mask, positions, paged=paged, kv=kv)
        return self.final_layer_norm(x)
