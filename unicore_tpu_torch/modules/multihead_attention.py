"""Self and cross multi-head attention (counterparts of
``SelfMultiheadAttention`` and ``CrossMultiheadAttention`` in
``unicore_tpu/modules/multihead_attention.py``).

Three paths of the self-attention:

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
  version on the CPU).  ``return_attn`` always takes the materialized
  path and returns the scores and probabilities beside the output.  The
  decoder's causal full forward is also the serve engine's oracle;
- the paged decode path (``paged`` given): this step's k/v are written
  into the layer's pool pages at ``paged.slot_mapping`` (in place), then
  each row attends the pages its table names through
  :func:`unicore_tpu_torch.ops.paged_attention.ragged_paged_attention`;
- the dense-cache decode path (``cache`` given, the JAX
  ``_decode_attend``): this step's k/v are written into the layer's
  :class:`DecodeCache` buffers (in place) and the queries attend the
  whole cache with ``einsum`` and an fp32 softmax, as the JAX package
  does it outside any kernel.

Parameter names follow the reference torch model (``in_proj``,
``out_proj``; both :class:`~.dense.FlaxDense`, the bias added after the
product rounds, as flax's): ``in_proj`` is ``Linear(D, 3D)`` whose
output features are laid out q-block, k-block, v-block, each
``[H, Dh]`` — the JAX package's ``DenseGeneral`` kernel
``[D, 3, H, Dh]`` is ``in_proj.weight.T`` reshaped.  The cross-attention
has separate ``q_proj``, ``k_proj``, ``v_proj`` and ``out_proj`` and the
same dispatch as the full forward, Tq and Tk apart.  Packed
``segment_ids`` are not ported yet (ROADMAP.md A11); with a decode cache
they, ``return_attn``, a bias and a key padding mask meet the JAX
refusals.
"""

import dataclasses
from typing import List

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
            generator, causal=False, return_attn=False):
    """Core attention, q [B, Tq, H, D] and k/v [B, Tk, H, D] -> [B, Tq, H,
    D]: the JAX ``_attend``'s dispatch without its sequence-parallel and
    segment paths.  With ``return_attn``, ``(o, attn_weights, probs)``:
    the scores with the padding and the bias (the causal mask folded in)
    added in their own type, and softmax_dropout's output, called with no
    bias; this never takes flash."""
    bias4 = bias
    if bias4 is not None and bias4.dim() < 4:
        bias4 = bias4.reshape((1,) * (4 - bias4.dim()) + tuple(bias4.shape))
    qs = (q.shape[0], q.shape[2], q.shape[1], q.shape[3])
    ks = (k.shape[0], k.shape[2], k.shape[1], k.shape[3])
    if not return_attn and eligible(
            qs, ks, None if bias4 is None else tuple(bias4.shape)):
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
    if return_attn:
        # the bias meets the scores in their type (under fp16 the causal
        # fill becomes -inf), then the softmax runs without one
        if bias is not None:
            s = s + bias.to(s.dtype)
        probs = softmax_dropout(s, dropout, is_training=training,
                                generator=generator)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v), s, probs
    probs = softmax_dropout(s, dropout, is_training=training, bias=bias,
                            generator=generator)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


# the JAX package's refusals on its decode paths (dense cache or paged)
DECODE_BIAS_REFUSAL = (
    "decode=True does not support attn_bias/key_padding_mask (decoding "
    "assumes unpadded prompts; generate() enforces this)")
DECODE_RETURN_ATTN_REFUSAL = "decode=True with return_attn"
DECODE_SEGMENT_REFUSAL = (
    "decode=True with segment_ids (sequence packing is a training-path "
    "feature; decode rows are one sequence each by construction)")
DECODE_ROTARY_REFUSAL = (
    "decode=True with rotary requires positions= (the global positions "
    "of the current tokens) — without them every step would rotate at "
    "position 0")


@dataclasses.dataclass
class DecodeCache:
    """The dense decode cache of a decoder (flax's ``"cache"``
    collection): per layer ``[cached_key, cached_value]``, each
    ``[B, capacity + 1, H, Dh]``, and the ``cache_index`` every layer
    shares (an int32 0-dim tensor on the cache's device).  The slot past
    the capacity is the trash slot: inactive rows of a ragged step
    (position -1) write their k/v there, and no mask ever admits it.  A
    step writes the buffers and advances the index in place."""

    kv: List[List[torch.Tensor]]
    index: torch.Tensor

    @classmethod
    def allocate(cls, layers, batch, capacity, heads, head_dim, dtype,
                 device):
        shape = (batch, capacity + 1, heads, head_dim)
        kv = [[torch.zeros(shape, dtype=dtype, device=device)
               for _ in range(2)] for _ in range(layers)]
        return cls(kv, torch.zeros((), dtype=torch.int32, device=device))

    def layer(self, i):
        """Layer ``i``'s ``(cached_key, cached_value, cache_index)``."""
        return self.kv[i][0], self.kv[i][1], self.index

    def advance(self, positions, tgt_len):
        """Move the index past a step of ``tgt_len`` tokens: by
        ``tgt_len`` on the contiguous path, to ``max(index,
        max(positions) + 1)`` on the ragged one (2-D ``positions``)."""
        if positions is not None and positions.dim() == 2:
            self.index = torch.maximum(
                self.index, positions.max().to(torch.int32) + 1)
        else:
            self.index = self.index + tgt_len


def _decode_mask(idx, tgt_len, cache_len):
    """Additive fp32 [tgt_len, cache_len] mask for incremental decoding:
    query row r (global position idx + r) sees keys <= idx + r;
    unwritten cache slots (>= idx + tgt_len) are masked by the same
    comparison.  ``idx`` is a 0-dim tensor on the mask's device."""
    rows = torch.arange(tgt_len, dtype=torch.int32, device=idx.device)
    cols = torch.arange(cache_len, dtype=torch.int32, device=idx.device)
    return torch.where(cols[None, :] > rows[:, None] + idx, -1e30, 0.0)


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
                kv=None, cache=None, return_attn=False, segment_ids=None):
        """``query`` [B, T, D].  ``key_padding_mask`` [B, T] (True/1 =
        pad) applies to the full forwards only; the decoder drops it on
        the decode paths, as the JAX decoder does.  ``return_attn``
        (full forward only) returns ``(out, attn_weights, probs)``, the
        [B, H, T, T] scores and probabilities.  Dropout is on in
        training mode and draws from ``generator`` (on ``query``'s
        device).  ``positions`` [B, T] global positions (-1 = padded
        column) are required with ``paged``, together with this layer's
        ``kv = (k_pages, v_pages)`` pools.  ``cache`` is this layer's
        :meth:`DecodeCache.layer`; ``positions`` then are [T] (the
        contiguous path, writing at the cache index) or [B, T] (ragged:
        each row at its own positions, -1 = inactive)."""
        if paged is not None or cache is not None:
            if attn_bias is not None or key_padding_mask is not None:
                raise NotImplementedError(DECODE_BIAS_REFUSAL)
            if return_attn:
                raise NotImplementedError(DECODE_RETURN_ATTN_REFUSAL)
            if segment_ids is not None:
                raise NotImplementedError(DECODE_SEGMENT_REFUSAL)
            if positions is None and self.rotary:
                raise ValueError(DECODE_ROTARY_REFUSAL)
        elif segment_ids is not None:
            raise NotImplementedError(
                "segment_ids is not ported to unicore_tpu_torch yet "
                "(ROADMAP.md A11)")
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
        elif cache is not None:
            o = self._decode_attend(q, k, v, positions, cache)
        else:
            o = _attend(q, k, v, self.scaling, self.dropout,
                        key_padding_mask,
                        _canon_bias(attn_bias, bsz, self.num_heads),
                        self.training, generator, causal=causal,
                        return_attn=return_attn)
            if return_attn:
                o, attn_weights, probs = o
        out = self.out_proj(o.reshape(bsz, tgt_len, self.embed_dim))
        return (out, attn_weights, probs) if return_attn else out

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

    def _decode_attend(self, q, k, v, positions, cache):
        """Dense KV-cache attention (the JAX ``_decode_attend``): write
        this step's k/v into the cache in place, then attend the queries
        over the whole cache, the masked scores filled with -1e30 and the
        softmax in fp32."""
        cached_key, cached_value, idx = cache
        cache_len = cached_key.shape[1]
        if positions is not None and positions.dim() == 2:
            # ragged: row r of sequence b writes at its OWN position
            # (slot == position), inactive rows (-1) at the trash slot;
            # each row attends keys <= its position
            bsz = positions.shape[0]
            trash = cache_len - 1
            slots = torch.where(positions >= 0, positions,
                                torch.full_like(positions, trash)).long()
            rows = torch.arange(bsz, device=q.device)[:, None] * cache_len
            flat = (rows + slots).reshape(-1)
            for buf, new in ((cached_key, k), (cached_value, v)):
                buf.view(-1, *buf.shape[2:]).index_copy_(
                    0, flat, new.reshape(-1, *new.shape[2:]).to(buf.dtype))
            cols = torch.arange(cache_len, device=q.device)
            mask = torch.where(
                cols[None, None, None, :] > positions[:, None, :, None],
                -1e30, 0.0)
        else:
            # contiguous: at the cache index, the start clamped so the
            # block fits (jax.lax.dynamic_update_slice)
            tgt_len = q.shape[1]
            start = idx.clamp(max=cache_len - tgt_len)
            cols = start + torch.arange(tgt_len, device=q.device)
            for buf, new in ((cached_key, k), (cached_value, v)):
                buf.index_copy_(1, cols, new.to(buf.dtype))
            mask = _decode_mask(idx, tgt_len, cache_len)[None, None]
        s = torch.einsum("bqhd,bkhd->bhqk",
                         q * rounded_constant(self.scaling, q.dtype),
                         cached_key)
        # the weakly typed fp32 mask meets the scores in their dtype
        s = s + mask.to(s.dtype)
        p = torch.softmax(s.float(), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, cached_value)


class CrossMultiheadAttention(nn.Module):
    """Attention of ``query`` [B, Tq, D] over ``key``/``value`` [B, Tk,
    D] (the decoder's ``encoder_attn``).  ``key_padding_mask`` [B, Tk]
    (True/1 = pad); ``attn_bias`` broadcastable to [B, H, Tq, Tk] or the
    reference's [B*H, Tq, Tk].  Flash where the shapes are eligible (Tq
    and Tk multiples of 128, a batch-broadcast bias), else the
    materialized softmax_dropout path; dropout draws from ``generator``
    in training mode."""

    def __init__(self, embed_dim, num_heads, dropout=0.1, bias=True,
                 scaling_factor=1.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.scaling = (self.head_dim * scaling_factor) ** -0.5
        self.q_proj = FlaxDense(embed_dim, embed_dim, bias=bias)
        self.k_proj = FlaxDense(embed_dim, embed_dim, bias=bias)
        self.v_proj = FlaxDense(embed_dim, embed_dim, bias=bias)
        self.out_proj = FlaxDense(embed_dim, embed_dim, bias=bias)

    def forward(self, query, key, value, key_padding_mask=None,
                attn_bias=None, generator=None):
        bsz, tgt_len, _ = query.shape

        def heads(x):
            return x.view(x.shape[0], x.shape[1], self.num_heads,
                          self.head_dim)

        o = _attend(heads(self.q_proj(query)), heads(self.k_proj(key)),
                    heads(self.v_proj(value)), self.scaling, self.dropout,
                    key_padding_mask,
                    _canon_bias(attn_bias, bsz, self.num_heads),
                    self.training, generator)
        return self.out_proj(o.reshape(bsz, tgt_len, self.embed_dim))
