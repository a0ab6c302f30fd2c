"""Self-attention-only transformer decoder (counterpart of
``TransformerDecoderLayer``/``TransformerDecoder`` in
``unicore_tpu/modules/transformer_decoder.py``), causal.

The stack: ``emb_layer_norm``, embedding dropout, the padding-mask
multiply, the bucketed relative-position bias (``rel_pos``, one
``[1, H, T, T]`` table in x's dtype shared by every layer), the layers,
and ``final_layer_norm`` unless ``post_ln``.  A layer is pre-LN (default)
or post-LN, with residual, attention and activation dropout drawn from
the caller's ``generator`` as the encoder's are.  fc1 and fc2 are
:class:`~.dense.FlaxDense`: the bias adds after the product rounds, as
flax's ``nn.Dense``.  Causal masking goes to the attention as a flag, so
flash masks in its kernels and the materialized path folds an iota mask
into its bias.

Two decode paths, each dropping the key padding mask from the attention
as the JAX decoder does: ``paged`` (the serve engine's pool) and
``cache`` (a :class:`~.multihead_attention.DecodeCache`, ``generate()``'s
dense cache, advanced in place).  The decoder refuses what the JAX one
refuses: decoding with the relative-position bias, and packed
``segment_ids`` with it; packing itself is not ported (ROADMAP.md A11).
Cross-attention is not ported (A3).
"""

from torch import nn

from ..ops.dropout import dropout as ops_dropout
from ..utils import get_activation_fn
from .dense import FlaxDense
from .layer_norm import LayerNorm
from .multihead_attention import SelfMultiheadAttention
from .transformer_encoder import RelativePositionBias

# the JAX decoder's refusal to decode with the relative-position bias
DECODE_REL_POS_REFUSAL = (
    "incremental decoding needs a position scheme that does not "
    "materialize a [T, T] bias at a traced offset — build the decoder "
    "with rel_pos=False (use rotary or absolute positions)")


class TransformerDecoderLayer(nn.Module):
    def __init__(self, embed_dim=768, ffn_embed_dim=3072, attention_heads=8,
                 dropout=0.1, attention_dropout=0.1, activation_dropout=0.0,
                 activation_fn="gelu", post_ln=False, rotary=False):
        super().__init__()
        self.dropout = dropout
        self.activation_dropout = activation_dropout
        self.post_ln = post_ln
        self.act = get_activation_fn(activation_fn)
        self.self_attn_layer_norm = LayerNorm(embed_dim)
        self.self_attn = SelfMultiheadAttention(
            embed_dim, attention_heads, dropout=attention_dropout,
            rotary=rotary)
        self.final_layer_norm = LayerNorm(embed_dim)
        self.fc1 = FlaxDense(embed_dim, ffn_embed_dim)
        self.fc2 = FlaxDense(ffn_embed_dim, embed_dim)

    def _drop(self, x, rate, generator):
        if not self.training or rate == 0.0:
            return x
        return ops_dropout(x, rate, generator)

    def forward(self, x, attn_bias=None, padding_mask=None, generator=None,
                positions=None, paged=None, kv=None, cache=None):
        decode = paged is not None or cache is not None
        residual = x
        if not self.post_ln:
            x = self.self_attn_layer_norm(x)
        x = self.self_attn(
            x, key_padding_mask=None if decode else padding_mask,
            attn_bias=attn_bias, causal=True, generator=generator,
            positions=positions, paged=paged, kv=kv, cache=cache,
        )
        x = residual + self._drop(x, self.dropout, generator)
        if self.post_ln:
            x = self.self_attn_layer_norm(x)
        residual = x
        if not self.post_ln:
            x = self.final_layer_norm(x)
        x = self._drop(self.act(self.fc1(x)), self.activation_dropout,
                       generator)
        x = residual + self._drop(self.fc2(x), self.dropout, generator)
        if self.post_ln:
            x = self.final_layer_norm(x)
        return x


class TransformerDecoder(nn.Module):
    def __init__(self, decoder_layers=6, embed_dim=768, ffn_embed_dim=3072,
                 attention_heads=8, emb_dropout=0.1, dropout=0.1,
                 attention_dropout=0.1, activation_dropout=0.0,
                 max_seq_len=256, activation_fn="gelu", rel_pos=True,
                 rel_pos_bins=32, max_rel_pos=128, post_ln=False,
                 rotary=False):
        super().__init__()
        self.emb_dropout = emb_dropout
        self.post_ln = post_ln
        self.emb_layer_norm = LayerNorm(embed_dim)
        self.relative_attention_bias = (
            RelativePositionBias(rel_pos_bins, attention_heads, max_seq_len,
                                 max_rel_pos) if rel_pos else None)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(embed_dim, ffn_embed_dim, attention_heads,
                                    dropout, attention_dropout,
                                    activation_dropout, activation_fn,
                                    post_ln, rotary)
            for _ in range(decoder_layers))
        self.final_layer_norm = None if post_ln else LayerNorm(embed_dim)

    def forward(self, emb, padding_mask=None, generator=None, positions=None,
                paged=None, segment_ids=None, cache=None):
        """``paged`` (a :class:`~unicore_tpu_torch.serve.attention.
        PagedMeta`) carries one ``(k_pages, v_pages)`` pair per layer;
        ``cache`` (a :class:`~.multihead_attention.DecodeCache`) one
        dense ``[cached_key, cached_value]`` pair per layer."""
        rel_pos = self.relative_attention_bias is not None
        if segment_ids is not None:
            if rel_pos:
                raise NotImplementedError(
                    "sequence packing (segment_ids) with rel_pos=True: the "
                    "relative-position bias is global-offset-indexed and "
                    "cannot reset per segment — build the decoder with "
                    "rel_pos=False (rotary or absolute positions)")
            raise NotImplementedError(
                "sequence packing (segment_ids) is not ported to "
                "unicore_tpu_torch yet (ROADMAP.md A11)")
        if (paged is not None or cache is not None) and rel_pos:
            raise NotImplementedError(DECODE_REL_POS_REFUSAL)
        seq_len = emb.shape[1]
        x = self.emb_layer_norm(emb)
        if self.training and self.emb_dropout > 0.0:
            x = ops_dropout(x, self.emb_dropout, generator)
        if padding_mask is not None:
            x = x * (1 - padding_mask[..., None].to(x.dtype))
        attn_bias = None
        if rel_pos:
            # compute-dtype bias, as the reference: every layer re-reads it
            attn_bias = self.relative_attention_bias(seq_len).to(x.dtype)
        for i, layer in enumerate(self.layers):
            kv = None if paged is None else paged.kv_pages[i]
            x = layer(x, attn_bias, padding_mask, generator, positions,
                      paged=paged, kv=kv,
                      cache=None if cache is None else cache.layer(i))
        if cache is not None:
            cache.advance(positions, seq_len)
        if self.final_layer_norm is not None:
            x = self.final_layer_norm(x)
        return x
