"""Self multi-head attention (counterpart of ``SelfMultiheadAttention``
in ``unicore_tpu/modules/multihead_attention.py``).

Two paths:

- the full forward (no ``paged``): key padding mask, additive
  ``attn_bias`` (batch-broadcast ``[1, H|1, T|1, T]``, or the reference's
  ``[B*H, T, T]``), ``causal`` masking, attention dropout drawn from
  ``generator``.  Shapes that :func:`~unicore_tpu_torch.ops.
  flash_attention.eligible` admits take flash, causal as a flag to the
  kernels (the CUDA kernels on the card, their plain version on the
  CPU); others take the materialized path as the JAX package does: the
  key padding added to the scores, the causal iota mask folded into the
  bias, then :func:`~unicore_tpu_torch.ops.softmax_dropout.
  softmax_dropout` with that bias (its kernel on the card, its plain
  version on the CPU).  The decoder's causal full forward is also the
  serve engine's oracle;
- the paged decode path (``paged`` given): this step's k/v are written
  into the layer's pool pages at ``paged.slot_mapping`` (in place), then
  each row attends the pages its table names through
  :func:`unicore_tpu_torch.ops.paged_attention.ragged_paged_attention`.

Parameter names follow the reference torch model (``in_proj``,
``out_proj``; both :class:`~.dense.FlaxDense`, the bias added after the
product rounds, as flax's): ``in_proj`` is ``Linear(D, 3D)`` whose
output features are laid out q-block, k-block, v-block, each
``[H, Dh]`` — the JAX package's ``DenseGeneral`` kernel
``[D, 3, H, Dh]`` is ``in_proj.weight.T`` reshaped.  The cross-attention module, ``return_attn``, packed
``segment_ids`` and the dense ``_decode_attend`` cache are not ported yet.
"""

import torch
from torch import nn

from ..ops.flash_attention import eligible, flash_attention
from ..ops.paged_attention import ragged_paged_attention
from ..ops.softmax_dropout import softmax_dropout
from ..utils import causal_iota_mask, rounded_constant
from .dense import FlaxDense
from .rotary import apply_rotary_qk


def _canon_bias(bias, bsz, num_heads):
    """Accept [B*H, q, k] (reference convention) or anything broadcastable
    to [B, H, q, k]."""
    if bias is None:
        return None
    if bias.dim() == 3 and bias.shape[0] == bsz * num_heads:
        return bias.reshape(bsz, num_heads, bias.shape[1], bias.shape[2])
    return bias


def _padding_bias(key_padding_mask):
    """[B, S] mask (True/1 = pad) -> additive fp32 [B, 1, 1, S] -inf bias."""
    return torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                       device=key_padding_mask.device).masked_fill(
        key_padding_mask.bool(), float("-inf"))[:, None, None, :]


def _attend(q, k, v, scaling, dropout, key_padding_mask, bias, training,
            generator, causal=False):
    """Core attention, q/k/v [B, T, H, D] -> [B, T, H, D]: the JAX
    ``_attend``'s dispatch without its sequence-parallel and segment
    paths."""
    bias4 = bias
    if bias4 is not None and bias4.dim() < 4:
        bias4 = bias4.reshape((1,) * (4 - bias4.dim()) + tuple(bias4.shape))
    qs = (q.shape[0], q.shape[2], q.shape[1], q.shape[3])
    ks = (k.shape[0], k.shape[2], k.shape[1], k.shape[3])
    if eligible(qs, ks, None if bias4 is None else tuple(bias4.shape)):
        return flash_attention(
            q, k, v, bias=bias4, key_padding_mask=key_padding_mask,
            causal=causal, dropout_prob=dropout, generator=generator,
            is_training=training, scale=scaling)
    # jax rounds the Python scalar to q's dtype before the product
    s = torch.einsum("bqhd,bkhd->bhqk",
                     q * rounded_constant(scaling, q.dtype), k)
    if key_padding_mask is not None:
        s = s + _padding_bias(key_padding_mask).to(q.dtype)
    if causal:
        # fp32 -1e30 fill, as the reference's _causal_bias: a bias of x's
        # type promotes to fp32 with it
        cb = causal_iota_mask(q.shape[1], k.shape[1], device=q.device)
        bias = cb[None, None] if bias is None else bias + cb
    probs = softmax_dropout(s, dropout, is_training=training, bias=bias,
                            generator=generator)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


class SelfMultiheadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, dropout=0.0, bias=True,
                 scaling_factor=1.0, rotary=False, rotary_base=10000.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.scaling = (self.head_dim * scaling_factor) ** -0.5
        self.rotary = rotary
        self.rotary_base = rotary_base
        self.in_proj = FlaxDense(embed_dim, 3 * embed_dim, bias=bias)
        self.out_proj = FlaxDense(embed_dim, embed_dim, bias=bias)

    def forward(self, query, key_padding_mask=None, attn_bias=None,
                causal=False, generator=None, positions=None, paged=None,
                kv=None):
        """``query`` [B, T, D].  ``key_padding_mask`` [B, T] (True/1 =
        pad) applies to the full forwards only; the paged path drops it,
        as the JAX decoder does.  Dropout is on in training mode and
        draws from ``generator`` (on ``query``'s device).  ``positions``
        [B, T] global positions (-1 = padded column) are required with
        ``paged``, together with this layer's ``kv = (k_pages,
        v_pages)`` pools."""
        bsz, tgt_len, _ = query.shape
        qkv = self.in_proj(query).view(bsz, tgt_len, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(2)
        if self.rotary:
            q, k = apply_rotary_qk(q, k, base=self.rotary_base,
                                   positions=positions)
        if paged is not None:
            if positions is None or kv is None:
                raise ValueError(
                    "paged decode needs positions= ([B, T] global "
                    "positions of the current tokens) and kv= (this "
                    "layer's pools)")
            o = self._paged_attend(q, k, v, paged, positions, kv)
        else:
            o = _attend(q, k, v, self.scaling, self.dropout,
                        key_padding_mask,
                        _canon_bias(attn_bias, bsz, self.num_heads),
                        self.training, generator, causal=causal)
        return self.out_proj(o.reshape(bsz, tgt_len, self.embed_dim))

    def _paged_attend(self, q, k, v, paged, positions, kv):
        k_pages, v_pages = kv
        shape = (-1, self.num_heads, self.head_dim)
        # in place: the pools are the engine's, allocated once
        k_pages.index_copy_(0, paged.slot_mapping,
                            k.reshape(shape).to(k_pages.dtype))
        v_pages.index_copy_(0, paged.slot_mapping,
                            v.reshape(shape).to(v_pages.dtype))
        return ragged_paged_attention(
            q.contiguous(), k_pages, v_pages, paged.page_table, positions,
            paged.lengths, page_size=paged.page_size, scale=self.scaling,
        )

