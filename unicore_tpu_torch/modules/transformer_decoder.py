"""Transformer decoder with causal self-attention and optional
cross-attention (counterpart of ``TransformerDecoderLayer``/
``TransformerDecoder`` in ``unicore_tpu/modules/transformer_decoder.py``).

The stack: ``emb_layer_norm``, embedding dropout, the padding-mask
multiply, the additive ``attn_mask`` (a 3-D ``[B*H, T, T]`` one reshaped
to ``[B, H, T, T]``) plus the bucketed relative-position bias
(``rel_pos``, one ``[1, H, T, T]`` table), cast to x's dtype and shared
by every layer, the layers, and ``final_layer_norm`` unless ``post_ln``.
A layer is pre-LN (default) or post-LN: self-attention, then, given
``encoder_out``, cross-attention over it (``encoder_attn`` after
``encoder_attn_layer_norm``), then the FFN, each with residual dropout,
and attention and activation dropout, drawn from the caller's
``generator`` as the encoder's are.  fc1 and fc2 are
:class:`~.dense.FlaxDense`: the bias adds after the product rounds, as
flax's ``nn.Dense``.  Causal masking (``auto_regressive``, on by default)
goes to the attention as a flag, so flash masks in its kernels and the
materialized path folds an iota mask into its bias.

A flax module creates the cross-attention's parameters at its first call
with ``encoder_out``; a torch module has them from its constructor, so
the decoder builds ``encoder_attn`` only when it is built with
``encoder_attn=True`` (a decoder-only LM's state dict holds none), and
refuses ``encoder_out`` otherwise.  ``checkpoint_activations``
recomputes each layer's activations in backward
(:func:`~.remat.remat`) when training with gradients on.

Two decode paths, each dropping the key padding mask from the attention
as the JAX decoder does: ``paged`` (the serve engine's pool) and
``cache`` (a :class:`~.multihead_attention.DecodeCache`, ``generate()``'s
dense cache, advanced in place); there the cross-attention runs over the
whole ``encoder_out`` at every step, as the JAX decoder's does.  The
decoder refuses what the JAX one refuses: decoding with the
relative-position bias, and packed ``segment_ids`` with it; packing
itself is not ported (ROADMAP.md A11).
"""

import torch
from torch import nn

from ..ops.dropout import dropout as ops_dropout
from ..utils import get_activation_fn
from .dense import FlaxDense
from .layer_norm import LayerNorm
from .multihead_attention import (CrossMultiheadAttention,
                                  SelfMultiheadAttention)
from .remat import remat
from .transformer_encoder import RelativePositionBias

# the JAX decoder's refusal to decode with the relative-position bias
DECODE_REL_POS_REFUSAL = (
    "incremental decoding needs a position scheme that does not "
    "materialize a [T, T] bias at a traced offset — build the decoder "
    "with rel_pos=False (use rotary or absolute positions)")


class TransformerDecoderLayer(nn.Module):
    def __init__(self, embed_dim=768, ffn_embed_dim=3072, attention_heads=8,
                 dropout=0.1, attention_dropout=0.1, activation_dropout=0.0,
                 activation_fn="gelu", post_ln=False, rotary=False,
                 encoder_attn=False):
        super().__init__()
        self.dropout = dropout
        self.activation_dropout = activation_dropout
        self.post_ln = post_ln
        self.act = get_activation_fn(activation_fn)
        self.self_attn_layer_norm = LayerNorm(embed_dim)
        self.self_attn = SelfMultiheadAttention(
            embed_dim, attention_heads, dropout=attention_dropout,
            rotary=rotary)
        self.encoder_attn_layer_norm = self.encoder_attn = None
        if encoder_attn:
            self.encoder_attn_layer_norm = LayerNorm(embed_dim)
            self.encoder_attn = CrossMultiheadAttention(
                embed_dim, attention_heads, dropout=attention_dropout)
        self.final_layer_norm = LayerNorm(embed_dim)
        self.fc1 = FlaxDense(embed_dim, ffn_embed_dim)
        self.fc2 = FlaxDense(ffn_embed_dim, embed_dim)

    def _drop(self, x, rate, generator):
        if not self.training or rate == 0.0:
            return x
        return ops_dropout(x, rate, generator)

    def forward(self, x, attn_bias=None, padding_mask=None, generator=None,
                positions=None, paged=None, kv=None, cache=None,
                encoder_out=None, encoder_padding_mask=None,
                encoder_attn_bias=None, causal=True):
        decode = paged is not None or cache is not None
        residual = x
        if not self.post_ln:
            x = self.self_attn_layer_norm(x)
        x = self.self_attn(
            x, key_padding_mask=None if decode else padding_mask,
            attn_bias=attn_bias, causal=causal, generator=generator,
            positions=positions, paged=paged, kv=kv, cache=cache,
        )
        x = residual + self._drop(x, self.dropout, generator)
        if self.post_ln:
            x = self.self_attn_layer_norm(x)
        if encoder_out is not None:
            if self.encoder_attn is None:
                raise ValueError(
                    "encoder_out given to a decoder layer built without "
                    "cross-attention (build it with encoder_attn=True)")
            residual = x
            if not self.post_ln:
                x = self.encoder_attn_layer_norm(x)
            x = self.encoder_attn(
                x, encoder_out, encoder_out,
                key_padding_mask=encoder_padding_mask,
                attn_bias=encoder_attn_bias, generator=generator)
            x = residual + self._drop(x, self.dropout, generator)
            if self.post_ln:
                x = self.encoder_attn_layer_norm(x)
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
                 rotary=False, auto_regressive=True,
                 checkpoint_activations=False, encoder_attn=False):
        super().__init__()
        self.emb_dropout = emb_dropout
        self.post_ln = post_ln
        self.auto_regressive = auto_regressive
        self.checkpoint_activations = checkpoint_activations
        self.emb_layer_norm = LayerNorm(embed_dim)
        self.relative_attention_bias = (
            RelativePositionBias(rel_pos_bins, attention_heads, max_seq_len,
                                 max_rel_pos) if rel_pos else None)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(embed_dim, ffn_embed_dim, attention_heads,
                                    dropout, attention_dropout,
                                    activation_dropout, activation_fn,
                                    post_ln, rotary, encoder_attn)
            for _ in range(decoder_layers))
        self.final_layer_norm = None if post_ln else LayerNorm(embed_dim)

    def forward(self, emb, padding_mask=None, generator=None, positions=None,
                paged=None, segment_ids=None, cache=None, encoder_out=None,
                encoder_padding_mask=None, attn_mask=None,
                encoder_attn_mask=None):
        """``paged`` (a :class:`~unicore_tpu_torch.serve.attention.
        PagedMeta`) carries one ``(k_pages, v_pages)`` pair per layer;
        ``cache`` (a :class:`~.multihead_attention.DecodeCache`) one
        dense ``[cached_key, cached_value]`` pair per layer.
        ``encoder_out`` [B, S, D] with ``encoder_padding_mask`` [B, S]
        (True/1 = pad) and ``encoder_attn_mask`` (broadcastable to [B, H,
        T, S], or [B*H, T, S]) feed every layer's cross-attention."""
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
        bsz, seq_len = emb.shape[:2]
        x = self.emb_layer_norm(emb)
        if self.training and self.emb_dropout > 0.0:
            x = ops_dropout(x, self.emb_dropout, generator)
        if padding_mask is not None:
            x = x * (1 - padding_mask[..., None].to(x.dtype))
        attn_bias = attn_mask
        if attn_bias is not None and attn_bias.dim() == 3:
            attn_bias = attn_bias.reshape(bsz, -1, seq_len, seq_len)
        if rel_pos:
            rel = self.relative_attention_bias(seq_len)
            attn_bias = rel if attn_bias is None else attn_bias + rel
        if attn_bias is not None:
            # compute-dtype bias, as the reference: every layer re-reads it
            attn_bias = attn_bias.to(x.dtype)
        layer_kw = dict(encoder_out=encoder_out,
                        encoder_padding_mask=encoder_padding_mask,
                        encoder_attn_bias=encoder_attn_mask,
                        causal=self.auto_regressive)
        recompute = (self.checkpoint_activations and self.training
                     and torch.is_grad_enabled() and paged is None
                     and cache is None)
        for i, layer in enumerate(self.layers):
            if recompute:
                x = remat(layer, generator, x, attn_bias, padding_mask,
                          generator, positions, **layer_kw)
                continue
            kv = None if paged is None else paged.kv_pages[i]
            x = layer(x, attn_bias, padding_mask, generator, positions,
                      paged=paged, kv=kv,
                      cache=None if cache is None else cache.layer(i),
                      **layer_kw)
        if cache is not None:
            cache.advance(positions, seq_len)
        if self.final_layer_norm is not None:
            x = self.final_layer_norm(x)
        return x
