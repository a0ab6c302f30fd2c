"""Triangle attention, triangle multiplication and the Evoformer pair
block (counterpart of ``unicore_tpu/modules/triangle_attention.py``).

Scores are ``[B, G, H, Q, K]`` (G the row or column group): the pair bias
broadcasts over G (``[B, 1, H, Q, K]``) and the pair mask over H and Q
(``[B, G, 1, 1, K]``, -1e9 fp32), both added inside
:func:`~unicore_tpu_torch.ops.softmax_dropout.softmax_dropout` — the
5-D contracts its kernel reads by strides.  :func:`group_flash_attention`
keeps the JAX package's static rule: flash only from T = 512 or when the
materialized scores would pass 4 GB.

Submodules carry the flax modules' names (``layer_norm``, ``q_proj``,
``pair_bias``, ``gate``, ``out_proj``, ...) so that
``examples/evoformer/convert.py`` maps flax params one to one; flax's
defaults are kept: LayerNorm eps 1e-6, tanh-approximated gelu, gates from
zero kernels and unit biases.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import flash_attention as fa
from ..ops.softmax_dropout import softmax_dropout
from .layer_norm import FlaxLayerNorm, LayerNorm

FLAX_LN_EPS = 1e-6


class Dense(nn.Linear):
    """``nn.Linear`` with the flax initializer it stands for: ``"bert"``
    (normal(0.02) kernel, zero bias), ``"zeros"`` (zero kernel and bias)
    or ``"gate"`` (zero kernel, unit bias)."""

    def __init__(self, in_features, out_features, bias=True, init="bert"):
        super().__init__(in_features, out_features, bias=bias)
        self.init = init

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        if not hasattr(self, "init"):  # nn.Linear's own call in __init__
            return super().reset_parameters()
        if self.init == "bert":
            self.weight.normal_(0.0, 0.02, generator=generator)
        else:
            self.weight.zero_()
        if self.bias is not None:
            self.bias.fill_(1.0 if self.init == "gate" else 0.0)


def flax_layer_norm(dim):
    return FlaxLayerNorm(dim, eps=FLAX_LN_EPS)


def reset_evoformer_parameters(module, generator):
    """The JAX package's init, drawn from ``generator``: every
    :class:`Dense` by its initializer, LayerNorms to unit scale, the IPA's
    point weights to softplus's inverse of 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Dense):
                m.reset_parameters(generator)
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif hasattr(m, "reset_point_weights"):
                m.reset_point_weights()


def group_flash_attention(q, k, v, pair_bias, mask, dropout, training,
                          generator, scale):
    """Flash over the (B, G) groups folded into the batch: q/k/v ``[B, G,
    T, H, D]``, bias ``[1, 1, H, T, T]`` broadcast over G, validity mask
    ``[B, G, T]``.  Returns ``[B, G, T, H, D]``, or None where the JAX
    package's rule keeps the materialized path: T < 512 with scores under
    4 GB, a per-batch bias, or shapes flash does not take."""
    bsz, g, t, h, d = q.shape
    score_gb = bsz * g * h * t * t * 4 / (1 << 30)
    if t < 512 and score_gb < 4.0:
        return None
    bias = None
    if pair_bias is not None:
        if pair_bias.shape[0] != 1:
            return None  # the kernel streams one bias for the whole batch
        bias = pair_bias[0]  # [1, H, T, T]
    qs = (bsz * g, h, t, d)
    if not fa.eligible(qs, qs, None if bias is None else tuple(bias.shape)):
        return None
    kpm = None
    if mask is not None:
        kpm = 1 - mask.reshape(bsz * g, t).to(torch.int32)  # nonzero = pad
    out = fa.flash_attention(
        q.reshape(bsz * g, t, h, d), k.reshape(bsz * g, t, h, d),
        v.reshape(bsz * g, t, h, d), bias=bias, key_padding_mask=kpm,
        dropout_prob=dropout, generator=generator, is_training=training,
        scale=scale)
    return out.reshape(bsz, g, t, h, d)


def additive_mask(mask):
    """[B, G, K] validity mask -> additive fp32 [B, G, 1, 1, K] (0 or
    -1e9: finite, so a fully masked row does not NaN)."""
    if mask is None:
        return None
    return torch.where(mask.bool(), 0.0, -1e9).float()[:, :, None, None, :]


class GatedAttention(nn.Module):
    """The gated attention body shared by the MSA and triangle attentions
    over a ``[B, G, Q, C]`` tensor: q/k/v projections without bias, flash
    or the materialized softmax_dropout path, a sigmoid gate from the
    input and the output projection."""

    def __init__(self, embed_dim, num_heads, dropout=0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.dropout = dropout
        self.q_proj = Dense(embed_dim, embed_dim, bias=False)
        self.k_proj = Dense(embed_dim, embed_dim, bias=False)
        self.v_proj = Dense(embed_dim, embed_dim, bias=False)
        self.gate = Dense(embed_dim, embed_dim, init="gate")
        self.out_proj = Dense(embed_dim, embed_dim)

    def attend(self, m, bias, mask, generator):
        """``m`` [B, G, Q, C]; ``bias`` broadcast against the scores [B, G,
        H, Q, Q]; ``mask`` the raw [B, G, Q] validity mask."""
        bsz, g, q_len, _ = m.shape
        shape = (bsz, g, q_len, self.num_heads, self.head_dim)
        q, k, v = (proj(m).view(shape)
                   for proj in (self.q_proj, self.k_proj, self.v_proj))
        scale = self.head_dim ** -0.5
        o = group_flash_attention(q, k, v, bias, mask, self.dropout,
                                  self.training, generator, scale)
        if o is None:
            scores = torch.einsum("bsqhd,bskhd->bshqk", q * scale, k)
            probs = softmax_dropout(
                scores, self.dropout, is_training=self.training,
                mask=additive_mask(mask), bias=bias, generator=generator)
            o = torch.einsum("bshqk,bskhd->bsqhd", probs, v)
        o = o.reshape(bsz, g, q_len, self.embed_dim)
        return self.out_proj(o * torch.sigmoid(self.gate(m)))


class TriangleAttention(GatedAttention):
    """Gated self-attention over a square pair tensor, row-wise
    (``"per_row"``, starting node) or column-wise (``"per_column"``,
    ending node: transpose in, transpose out), biased by a projection of
    the pair tensor itself."""

    def __init__(self, embed_dim, num_heads, orientation="per_row",
                 dropout=0.0):
        super().__init__(embed_dim, num_heads, dropout)
        if orientation not in ("per_row", "per_column"):
            raise ValueError(f"orientation {orientation!r}")
        self.orientation = orientation
        self.layer_norm = flax_layer_norm(embed_dim)
        self.pair_bias = Dense(embed_dim, num_heads, bias=False)

    def forward(self, z, mask=None, generator=None):
        """``z`` [B, N, N, C]; ``mask`` [B, N, N] (1 = valid)."""
        if self.orientation == "per_column":
            z = z.transpose(1, 2)
            mask = None if mask is None else mask.transpose(1, 2)
        if z.shape[1] != z.shape[2]:
            raise ValueError(f"triangle attention needs a square pair "
                             f"tensor, got {tuple(z.shape)}")
        z = self.layer_norm(z)
        # [B, N, N, H] -> [B, 1, H, N, N], broadcast over the group dim
        pair_bias = self.pair_bias(z).permute(0, 3, 1, 2)[:, None]
        o = self.attend(z, pair_bias, mask, generator)
        if self.orientation == "per_column":
            o = o.transpose(1, 2)
        return o


class TriangleMultiplication(nn.Module):
    """Triangle multiplicative update: edge (i, j) from ``sum_k a[i, k]
    b[j, k]`` (outgoing) or ``sum_k a[k, i] b[k, j]`` (incoming), gated
    projections in, LayerNorm, zero-initialized projection and a gate
    out."""

    def __init__(self, embed_dim, hidden_dim=None, direction="outgoing"):
        super().__init__()
        if direction not in ("outgoing", "incoming"):
            raise ValueError(f"direction {direction!r}")
        self.direction = direction
        hidden = hidden_dim or embed_dim
        self.layer_norm_in = flax_layer_norm(embed_dim)
        self.a_proj = Dense(embed_dim, hidden, bias=False)
        self.a_gate = Dense(embed_dim, hidden, init="gate")
        self.b_proj = Dense(embed_dim, hidden, bias=False)
        self.b_gate = Dense(embed_dim, hidden, init="gate")
        self.layer_norm_out = flax_layer_norm(hidden)
        self.out_proj = Dense(hidden, embed_dim, bias=False, init="zeros")
        self.out_gate = Dense(embed_dim, embed_dim, init="gate")

    def forward(self, z, mask=None):
        """``z`` [B, N, M, C]; ``mask`` [B, N, M] (1 = valid edge)."""
        zn = self.layer_norm_in(z)

        def gated(proj, gate):
            p = proj(zn) * torch.sigmoid(gate(zn))
            if mask is not None:
                p = p * mask.to(p.dtype)[..., None]
            return p

        a, b = gated(self.a_proj, self.a_gate), gated(self.b_proj,
                                                      self.b_gate)
        if self.direction == "outgoing":
            x = torch.einsum("bikc,bjkc->bijc", a, b)
        else:
            x = torch.einsum("bkic,bkjc->bijc", a, b)
        x = self.out_proj(self.layer_norm_out(x))
        return x * torch.sigmoid(self.out_gate(zn))


class Transition(nn.Module):
    """LayerNorm -> widen x n -> tanh gelu -> project back (the pair and
    MSA transitions)."""

    def __init__(self, embed_dim, widening=4):
        super().__init__()
        self.layer_norm = flax_layer_norm(embed_dim)
        self.fc1 = Dense(embed_dim, embed_dim * widening)
        self.fc2 = Dense(embed_dim * widening, embed_dim)

    def forward(self, x):
        h = F.gelu(self.fc1(self.layer_norm(x)), approximate="tanh")
        return self.fc2(h)


PairTransition = Transition


class EvoformerPairBlock(nn.Module):
    """The pair stack block: triangle multiplicative updates (outgoing,
    incoming), triangle attention (starting and ending node) and the pair
    transition, each residual."""

    def __init__(self, embed_dim, num_heads, dropout=0.0,
                 use_triangle_multiplication=True):
        super().__init__()
        self.use_triangle_multiplication = use_triangle_multiplication
        if use_triangle_multiplication:
            self.tri_mul_out = TriangleMultiplication(embed_dim,
                                                      direction="outgoing")
            self.tri_mul_in = TriangleMultiplication(embed_dim,
                                                     direction="incoming")
        self.tri_att_start = TriangleAttention(
            embed_dim, num_heads, orientation="per_row", dropout=dropout)
        self.tri_att_end = TriangleAttention(
            embed_dim, num_heads, orientation="per_column", dropout=dropout)
        self.pair_transition = PairTransition(embed_dim)

    def forward(self, z, mask=None, generator=None):
        if self.use_triangle_multiplication:
            z = z + self.tri_mul_out(z, mask)
            z = z + self.tri_mul_in(z, mask)
        z = z + self.tri_att_start(z, mask, generator)
        z = z + self.tri_att_end(z, mask, generator)
        return z + self.pair_transition(z)
