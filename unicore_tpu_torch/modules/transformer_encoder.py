"""Transformer encoder with T5-style bucketed relative position bias
(counterpart of ``unicore_tpu/modules/transformer_encoder.py``).

The bucket table is a static numpy computation; the bias stays
``[1, H, T, T]`` and broadcasts over the batch, so the flash kernels take
it as one batch-broadcast operand and never build ``[B, H, T, T]``.  The
key padding mask rides beside it, not merged into it.  Parameter names
are the reference torch model's (``layers.N.self_attn.in_proj`` ...).
``checkpoint_activations`` recomputes each layer's activations in
backward (:func:`~.remat.remat`) when training with gradients on.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import dropout as ops_dropout
from ..utils import get_activation_fn
from .dense import FlaxDense
from .layer_norm import LayerNorm
from .multihead_attention import SelfMultiheadAttention
from .remat import remat


def relative_position_bucket(relative_position, num_buckets=32,
                             max_distance=128):
    """Signed T5 bucketing on a numpy int array (the JAX package's host
    path, copied)."""
    sign = np.sign(relative_position)
    num_buckets //= 2
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    max_bucket_val = num_buckets - 1 - max_exact
    n_safe = np.maximum(n, 1)
    val_if_large = max_exact + np.ceil(
        np.log(n_safe.astype(np.float32) / max_exact)
        / np.log((max_distance - 1) / max_exact)
        * max_bucket_val
    ).astype(n.dtype)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return np.where(is_small, n, val_if_large) * sign


def make_rp_bucket(max_seq_len, num_buckets, max_distance):
    """Static [T, T] bucket-index table, shifted to be 0-based."""
    context = np.arange(max_seq_len, dtype=np.int64)[:, None]
    memory = np.arange(max_seq_len, dtype=np.int64)[None, :]
    rp = relative_position_bucket(memory - context, num_buckets=num_buckets,
                                  max_distance=max_distance)
    return (rp - rp.min()).astype(np.int32)


class RelativePositionBias(nn.Module):
    """Bucketed relative position bias -> broadcastable ``[1, H, T, T]``.
    ``weight`` is the reference's ``nn.Embedding`` table
    ``[num_buckets, H]``."""

    def __init__(self, num_buckets, num_heads, max_seq_len, max_distance):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(num_buckets, num_heads))
        self.register_buffer(
            "rp_bucket",
            torch.from_numpy(make_rp_bucket(max_seq_len, num_buckets,
                                            max_distance)).long(),
            persistent=False)

    def forward(self, seq_len):
        idx = self.rp_bucket[:seq_len, :seq_len]
        return F.embedding(idx, self.weight).permute(2, 0, 1)[None]


class TransformerEncoderLayer(nn.Module):
    """Pre/post-LN BERT-style encoder layer."""

    def __init__(self, embed_dim=768, ffn_embed_dim=3072, attention_heads=8,
                 dropout=0.1, attention_dropout=0.1, activation_dropout=0.0,
                 activation_fn="gelu", post_ln=False):
        super().__init__()
        self.dropout = dropout
        self.activation_dropout = activation_dropout
        self.post_ln = post_ln
        self.act = get_activation_fn(activation_fn)
        self.self_attn_layer_norm = LayerNorm(embed_dim)
        self.self_attn = SelfMultiheadAttention(
            embed_dim, attention_heads, dropout=attention_dropout)
        self.final_layer_norm = LayerNorm(embed_dim)
        self.fc1 = FlaxDense(embed_dim, ffn_embed_dim)
        self.fc2 = FlaxDense(ffn_embed_dim, embed_dim)

    def _drop(self, x, rate, generator):
        if not self.training or rate == 0.0:
            return x
        return ops_dropout(x, rate, generator)

    def forward(self, x, attn_bias=None, padding_mask=None, generator=None,
                return_attn=False):
        """With ``return_attn``, ``(x, attn_weights, attn_probs)``: the
        self-attention's [B, H, T, T] scores and probabilities beside the
        output."""
        residual = x
        if not self.post_ln:
            x = self.self_attn_layer_norm(x)
        x = self.self_attn(x, key_padding_mask=padding_mask,
                           attn_bias=attn_bias, generator=generator,
                           return_attn=return_attn)
        if return_attn:
            x, attn_weights, attn_probs = x
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
        if return_attn:
            return x, attn_weights, attn_probs
        return x


class TransformerEncoder(nn.Module):
    def __init__(self, encoder_layers=6, embed_dim=768, ffn_embed_dim=3072,
                 attention_heads=8, emb_dropout=0.1, dropout=0.1,
                 attention_dropout=0.1, activation_dropout=0.0,
                 max_seq_len=256, activation_fn="gelu", rel_pos=True,
                 rel_pos_bins=32, max_rel_pos=128, post_ln=False,
                 checkpoint_activations=False):
        super().__init__()
        self.emb_dropout = emb_dropout
        self.post_ln = post_ln
        self.checkpoint_activations = checkpoint_activations
        self.emb_layer_norm = LayerNorm(embed_dim)
        self.relative_attention_bias = (
            RelativePositionBias(rel_pos_bins, attention_heads, max_seq_len,
                                 max_rel_pos) if rel_pos else None)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(embed_dim, ffn_embed_dim, attention_heads,
                                    dropout, attention_dropout,
                                    activation_dropout, activation_fn,
                                    post_ln)
            for _ in range(encoder_layers))
        self.final_layer_norm = None if post_ln else LayerNorm(embed_dim)

    def forward(self, emb, attn_mask=None, padding_mask=None, generator=None):
        bsz, seq_len, _ = emb.shape
        x = self.emb_layer_norm(emb)
        if self.training and self.emb_dropout > 0.0:
            x = ops_dropout(x, self.emb_dropout, generator)
        if padding_mask is not None:
            x = x * (1 - padding_mask[..., None].to(x.dtype))
        if attn_mask is not None and attn_mask.dim() == 3:
            attn_mask = attn_mask.reshape(bsz, -1, seq_len, seq_len)
        if self.relative_attention_bias is not None:
            rel = self.relative_attention_bias(seq_len)
            attn_mask = rel if attn_mask is None else attn_mask + rel
        if attn_mask is not None:
            # compute-dtype bias, as the reference: every layer re-reads it
            attn_mask = attn_mask.to(x.dtype)
        recompute = (self.checkpoint_activations and self.training
                     and torch.is_grad_enabled())
        for layer in self.layers:
            if recompute:
                x = remat(layer, generator, x, attn_mask, padding_mask,
                          generator)
            else:
                x = layer(x, attn_mask, padding_mask, generator)
        if self.final_layer_norm is not None:
            x = self.final_layer_norm(x)
        return x
