"""MSA-stack modules and the Evoformer block (counterpart of
``unicore_tpu/modules/msa_attention.py``).

MSA representation ``m`` [B, S, R, C_m] (S sequences x R residues), pair
representation ``z`` [B, R, R, C_z].  Row attention scores are ``[B, S,
H, R, R]`` with the pair bias broadcast over S (``[B, 1, H, R, R]``) and
the MSA mask over heads and queries (``[B, S, 1, 1, R]``); column
attention transposes in and out and has no bias.  Both go through
:class:`~unicore_tpu_torch.modules.triangle_attention.GatedAttention`,
whose materialized path is the ``softmax_dropout`` kernel on the card.
Submodules carry the flax modules' names.
"""

import torch
from torch import nn

from .triangle_attention import (Dense, EvoformerPairBlock, GatedAttention,
                                 Transition, flax_layer_norm)

MSATransition = Transition


class MSARowAttentionWithPairBias(GatedAttention):
    """Gated row-wise MSA self-attention biased by the pair
    representation, the bias shared by every row."""

    def __init__(self, embed_dim, num_heads, pair_dim=None, dropout=0.0):
        super().__init__(embed_dim, num_heads, dropout)
        pair_dim = pair_dim or embed_dim
        self.layer_norm = flax_layer_norm(embed_dim)
        self.pair_norm = flax_layer_norm(pair_dim)
        self.pair_bias = Dense(pair_dim, num_heads, bias=False)

    def forward(self, msa, z, msa_mask=None, generator=None):
        """``msa`` [B, S, R, C_m]; ``z`` [B, R, R, C_z]; ``msa_mask`` [B,
        S, R]."""
        m = self.layer_norm(msa)
        # [B, R, R, H] -> [B, 1, H, R, R], broadcast over S
        pair_bias = self.pair_bias(self.pair_norm(z)).permute(
            0, 3, 1, 2)[:, None]
        return self.attend(m, pair_bias, msa_mask, generator)


class MSAColumnAttention(GatedAttention):
    """Gated column-wise MSA self-attention: each residue column attends
    across sequences."""

    def __init__(self, embed_dim, num_heads, dropout=0.0):
        super().__init__(embed_dim, num_heads, dropout)
        self.layer_norm = flax_layer_norm(embed_dim)

    def forward(self, msa, msa_mask=None, generator=None):
        mask = None if msa_mask is None else msa_mask.transpose(1, 2)
        m = self.layer_norm(msa.transpose(1, 2))  # [B, R, S, C]
        return self.attend(m, None, mask, generator).transpose(1, 2)


class OuterProductMean(nn.Module):
    """MSA -> pair communication: the masked mean over sequences of the
    outer product of two low-rank projections, normalized per (i, j) by
    the count of sequences valid at both residues (floored at 1e-3)."""

    def __init__(self, msa_dim, pair_dim, hidden_dim=32):
        super().__init__()
        self.layer_norm = flax_layer_norm(msa_dim)
        self.a_proj = Dense(msa_dim, hidden_dim, bias=False)
        self.b_proj = Dense(msa_dim, hidden_dim, bias=False)
        self.out_proj = Dense(hidden_dim * hidden_dim, pair_dim)

    def forward(self, msa, msa_mask=None):
        """``msa`` [B, S, R, C_m]; ``msa_mask`` [B, S, R] -> [B, R, R,
        C_z]."""
        m = self.layer_norm(msa)
        a, b = self.a_proj(m), self.b_proj(m)
        if msa_mask is not None:
            w = msa_mask.to(a.dtype)[..., None]
            a, b = a * w, b * w
            mf = msa_mask.float()
            norm = torch.einsum("bsi,bsj->bij", mf, mf)[..., None]
        else:
            norm = torch.tensor(float(msa.shape[1]), device=msa.device)
        outer = torch.einsum("bsic,bsjd->bijcd", a, b)
        outer = outer.reshape(outer.shape[:3] + (-1,))
        # divided in fp32 (the reference promotes), back to the compute type
        outer = (outer / torch.clamp(norm, min=1e-3)).to(a.dtype)
        return self.out_proj(outer)


class EvoformerBlock(nn.Module):
    """One Evoformer block: row attention with pair bias, column attention
    and transition on the MSA; the outer product mean into the pair; then
    the pair block.  Returns the updated ``(msa, z)``."""

    def __init__(self, msa_dim, pair_dim, msa_heads=8, pair_heads=4,
                 dropout=0.0, opm_hidden_dim=32,
                 use_triangle_multiplication=True):
        super().__init__()
        self.row_attn = MSARowAttentionWithPairBias(
            msa_dim, msa_heads, pair_dim=pair_dim, dropout=dropout)
        self.col_attn = MSAColumnAttention(msa_dim, msa_heads,
                                           dropout=dropout)
        self.msa_transition = MSATransition(msa_dim)
        self.outer_product_mean = OuterProductMean(
            msa_dim, pair_dim, hidden_dim=opm_hidden_dim)
        self.pair_block = EvoformerPairBlock(
            pair_dim, pair_heads, dropout=dropout,
            use_triangle_multiplication=use_triangle_multiplication)

    def forward(self, msa, z, msa_mask=None, pair_mask=None, generator=None):
        msa = msa + self.row_attn(msa, z, msa_mask, generator)
        msa = msa + self.col_attn(msa, msa_mask, generator)
        msa = msa + self.msa_transition(msa)
        z = z + self.outer_product_mean(msa, msa_mask)
        z = self.pair_block(z, pair_mask, generator)
        return msa, z
