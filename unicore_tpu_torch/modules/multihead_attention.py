"""Self multi-head attention (counterpart of ``SelfMultiheadAttention``
in ``unicore_tpu/modules/multihead_attention.py``).

Two paths, as the JAX module's decoder uses them:

- the plain causal full forward (no ``paged``): einsum + fp32 softmax
  over the whole sequence — the oracle the serve engine is held against;
- the paged decode path (``paged`` given): this step's k/v are written
  into the layer's pool pages at ``paged.slot_mapping`` (in place), then
  each row attends the pages its table names through
  :func:`unicore_tpu_torch.ops.paged_attention.ragged_paged_attention`.

Parameter names follow the reference torch model (``in_proj``,
``out_proj``): ``in_proj`` is ``Linear(D, 3D)`` whose output features are
laid out q-block, k-block, v-block, each ``[H, Dh]`` — the JAX package's
``DenseGeneral`` kernel ``[D, 3, H, Dh]`` is ``in_proj.weight.T``
reshaped.  The cross-attention module and the dense ``_decode_attend``
cache are not ported yet.
"""

import torch
from torch import nn

from ..ops.paged_attention import ragged_paged_attention
from ..utils import causal_iota_mask
from .rotary import apply_rotary_qk


class SelfMultiheadAttention(nn.Module):
    def __init__(self, embed_dim, num_heads, bias=True, scaling_factor=1.0,
                 rotary=False, rotary_base=10000.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.scaling = (self.head_dim * scaling_factor) ** -0.5
        self.rotary = rotary
        self.rotary_base = rotary_base
        self.in_proj = nn.Linear(embed_dim, 3 * embed_dim, bias=bias)
        self.out_proj = nn.Linear(embed_dim, embed_dim, bias=bias)

    def forward(self, query, key_padding_mask=None, positions=None,
                paged=None, kv=None):
        """``query`` [B, T, D].  ``key_padding_mask`` [B, T] (True/1 =
        pad) applies to the full forward only; the paged path drops it,
        as the JAX decoder does.  ``positions`` [B, T] global positions
        (-1 = padded column) are required with ``paged``, together with
        this layer's ``kv = (k_pages, v_pages)`` pools."""
        bsz, tgt_len, _ = query.shape
        qkv = self.in_proj(query).view(bsz, tgt_len, 3, self.num_heads,
                                       self.head_dim)
        q, k, v = qkv.unbind(2)
        if self.rotary:
            q, k = apply_rotary_qk(q, k, base=self.rotary_base,
                                   positions=positions)
        if paged is None:
            o = self._causal_attend(q, k, v, key_padding_mask)
        else:
            if positions is None or kv is None:
                raise ValueError(
                    "paged decode needs positions= ([B, T] global "
                    "positions of the current tokens) and kv= (this "
                    "layer's pools)")
            o = self._paged_attend(q, k, v, paged, positions, kv)
        return self.out_proj(o.reshape(bsz, tgt_len, self.embed_dim))

    def _causal_attend(self, q, k, v, key_padding_mask):
        s = torch.einsum("bqhd,bkhd->bhqk", q * self.scaling, k)
        if key_padding_mask is not None:
            s = s.masked_fill(key_padding_mask.bool()[:, None, None, :],
                              float("-inf"))
        s = s + causal_iota_mask(q.shape[1], k.shape[1], device=q.device)
        p = torch.softmax(s.float(), dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", p, v)

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
