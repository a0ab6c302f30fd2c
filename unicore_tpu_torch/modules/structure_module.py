"""Invariant point attention and the backbone update (counterpart of
``unicore_tpu/modules/structure_module.py``): AlphaFold's Algorithms 22
and 23, and the structure module that runs one shared-weight layer of
them ``n_layers`` times from identity frames.

Rigid transforms are ``(rot [..., 3, 3], trans [..., 3])`` tensor pairs.
The IPA's softmax and contractions are plain torch ops: the reference
computes them outside any ``pallas_call``, so no kernel stands behind
them.

Types follow flax's promotion: every projection is a
:class:`PromotingDense` and every LayerNorm a flax one, so the module
computes in the wider of its inputs' and its weights' types.  Fed fp32
inputs and bf16 weights (the Evoformer's ``--bf16`` compute copy, whose
``forward`` casts the single and pair representations up), it runs in
fp32 as the reference does, frames included.

Submodules carry the flax names (``q_proj`` ... ``out_proj``,
``point_weights``, ``ipa``, ``backbone_update.update``, ``single_in``,
``layer``), so that ``examples/evoformer/convert.py`` maps them one to
one.
"""

import torch
import torch.nn.functional as F
from torch import nn

from .dense import FlaxDense
from .triangle_attention import Dense, flax_layer_norm


class PromotingDense(FlaxDense, Dense):
    """:class:`~.triangle_attention.Dense`'s initializers with
    :class:`~.dense.FlaxDense`'s type promotion and bias rounding."""


# ----------------------------------------------------------------------
# rigid-transform helpers (rot: [..., 3, 3], trans: [..., 3])
# ----------------------------------------------------------------------

def quat_to_rot(q):
    """Quaternion [..., 4] (w, x, y, z), normalized here -> rotation
    [..., 3, 3]."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(
        1e-6)
    w, x, y, z = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _broadcast_frames(rot, trans, points):
    """rot and trans viewed against ``points`` [B, R, ..., 3]: the dims
    between R and the last broadcast (heads x points)."""
    extra = points.dim() - trans.dim()
    return (rot.reshape(rot.shape[:2] + (1,) * extra + (3, 3)),
            trans.reshape(trans.shape[:2] + (1,) * extra + (3,)))


def rigid_apply(rot, trans, points):
    """Local points [B, R, ..., 3] to global: rot @ p + trans."""
    r, t = _broadcast_frames(rot, trans, points)
    return (r * points[..., None, :]).sum(-1) + t


def rigid_invert_apply(rot, trans, points):
    """Global points [B, R, ..., 3] into the local frame: rot^T @ (p -
    trans)."""
    r, t = _broadcast_frames(rot, trans, points)
    return (r * (points - t)[..., :, None]).sum(-2)


def rigid_compose(rot_a, trans_a, rot_b, trans_b):
    """(a o b)(p) = a(b(p)): rot = Ra Rb, trans = Ra tb + ta."""
    rot = torch.einsum("...ij,...jk->...ik", rot_a, rot_b)
    trans = torch.einsum("...ij,...j->...i", rot_a, trans_b) + trans_a
    return rot, trans


def identity_rigid(batch_shape, dtype=torch.float32, device=None):
    rot = torch.eye(3, dtype=dtype, device=device).expand(
        *batch_shape, 3, 3)
    trans = torch.zeros(*batch_shape, 3, dtype=dtype, device=device)
    return rot, trans


def _softplus_inverse_of_one(n):
    """The reference's init of the point weights, log(e - 1) in fp32:
    softplus gives 1."""
    return torch.log(torch.exp(torch.ones(n)) - 1.0)


class InvariantPointAttention(nn.Module):
    """IPA (AlphaFold Algorithm 22) over a single representation ``s``
    [B, R, C], a pair representation ``z`` [B, R, R, pair_dim] and the
    backbone frames (rot, trans)."""

    def __init__(self, embed_dim, num_heads=8, qk_points=4, v_points=8,
                 pair_dim=None):
        super().__init__()
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                             f"num_heads {num_heads}")
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.n_qk_points, self.n_v_points = qk_points, v_points
        pair_dim = embed_dim if pair_dim is None else pair_dim
        h = num_heads

        def proj(width):
            return PromotingDense(embed_dim, width, bias=False)

        self.q_proj, self.k_proj, self.v_proj = (proj(embed_dim)
                                                 for _ in range(3))
        self.q_points = proj(h * qk_points * 3)
        self.k_points = proj(h * qk_points * 3)
        self.v_points = proj(h * v_points * 3)
        self.point_weights = nn.Parameter(_softplus_inverse_of_one(h))
        self.pair_bias = PromotingDense(pair_dim, h, bias=False)
        self.out_proj = PromotingDense(
            embed_dim + h * pair_dim + h * v_points * 4, embed_dim,
            init="zeros")

    @torch.no_grad()
    def reset_point_weights(self):
        self.point_weights.copy_(_softplus_inverse_of_one(self.num_heads))

    def forward(self, s, z, rot, trans, mask=None):
        """``mask`` [B, R] (1 = valid residue) cuts masked keys."""
        bsz, n_res, _ = s.shape
        h, pq, pv = self.num_heads, self.n_qk_points, self.n_v_points
        q, k, v = (p(s).view(bsz, n_res, h, self.head_dim)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        # local query/key/value points -> global through the frames
        qp_g = rigid_apply(rot, trans,
                           self.q_points(s).view(bsz, n_res, h, pq, 3))
        kp_g = rigid_apply(rot, trans,
                           self.k_points(s).view(bsz, n_res, h, pq, 3))
        vp_g = rigid_apply(rot, trans,
                           self.v_points(s).view(bsz, n_res, h, pv, 3))

        # Alg. 22 line 7: the scalar, pair and point terms balanced
        w_c = (2.0 / (9.0 * pq)) ** 0.5
        w_l = (1.0 / 3.0) ** 0.5
        gamma = self.point_weights
        # softplus as the reference writes it (logaddexp, not F.softplus's
        # thresholded log1p(exp)), in the weight's own type
        gamma = torch.logaddexp(gamma, torch.zeros_like(gamma))

        att = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.head_dim ** -0.5
        att = att + self.pair_bias(z).permute(0, 3, 1, 2)
        d2 = ((qp_g[:, :, None] - kp_g[:, None]) ** 2).sum(-1)  # [B,Q,K,H,P]
        att = att - torch.einsum("bqkhp,h->bhqk", d2,
                                 gamma.to(d2.dtype)) * (w_c / 2.0)
        att = att * w_l
        if mask is not None:
            att = att + torch.where(mask.bool(), 0.0, -1e9).float()[
                :, None, None, :]
        att = torch.softmax(att, dim=-1)

        o = torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(bsz, n_res, -1)
        # Alg. 22 line 11: each query gathers its own row of z
        o_pair = torch.einsum("bhqk,bqkc->bqhc", att, z.to(att.dtype)
                              ).reshape(bsz, n_res, -1)
        op_g = torch.einsum("bhqk,bkhpx->bqhpx", att, vp_g)
        op_l = rigid_invert_apply(rot, trans, op_g)  # back to local frames
        # eps under the root: sum of squares + eps has no 0/0 gradient
        op_norm = torch.sqrt((op_l ** 2).sum(-1) + 1e-8)
        out = torch.cat([o, o_pair, op_l.reshape(bsz, n_res, -1),
                         op_norm.reshape(bsz, n_res, -1)], dim=-1)
        return self.out_proj(out)


class BackboneUpdate(nn.Module):
    """Alg. 23: a (quaternion, translation) update per residue from the
    single representation, composed onto the frames.  The projection
    draws normal(0.02), not zeros: from a zero init every residue sits at
    the origin, where the distances' gradient is exactly 0 (a saddle that
    freezes training)."""

    def __init__(self, embed_dim):
        super().__init__()
        self.update = PromotingDense(embed_dim, 6)

    def forward(self, s, rot, trans):
        upd = self.update(s)
        bcd, t_upd = upd[..., :3], upd[..., 3:]
        # (1, b, c, d): the small-rotation parameterization
        quat = torch.cat([torch.ones_like(bcd[..., :1]), bcd], dim=-1)
        return rigid_compose(rot, trans, quat_to_rot(quat), t_upd)


class StructureModuleLayer(nn.Module):
    """One iteration: IPA -> LayerNorm -> transition -> LayerNorm ->
    backbone update (AlphaFold Alg. 20 lines 6-10)."""

    def __init__(self, embed_dim, num_heads=8, pair_dim=None):
        super().__init__()
        self.ipa = InvariantPointAttention(embed_dim, num_heads,
                                           pair_dim=pair_dim)
        self.ipa_norm = flax_layer_norm(embed_dim)
        self.fc1 = PromotingDense(embed_dim, embed_dim)
        self.fc2 = PromotingDense(embed_dim, embed_dim)
        self.transition_norm = flax_layer_norm(embed_dim)
        self.backbone_update = BackboneUpdate(embed_dim)

    def forward(self, s, z, rot, trans, mask=None):
        s = self.ipa_norm(s + self.ipa(s, z, rot, trans, mask))
        h = self.fc2(F.relu(self.fc1(s)))
        s = self.transition_norm(s + h)
        rot, trans = self.backbone_update(s, rot, trans)
        return s, rot, trans


class StructureModule(nn.Module):
    """``n_layers`` iterations of one shared-weight structure layer from
    the single [B, R, single_dim] and pair [B, R, R, pair_dim]
    representations, frames starting at identity.  Returns the final
    single representation, the frames and the per-residue positions (the
    translations: the C-alpha trace)."""

    def __init__(self, embed_dim, num_heads=8, n_layers=4, single_dim=None,
                 pair_dim=None):
        super().__init__()
        self.n_layers = n_layers
        single_dim = embed_dim if single_dim is None else single_dim
        pair_dim = embed_dim if pair_dim is None else pair_dim
        self.single_norm = flax_layer_norm(single_dim)
        self.pair_norm = flax_layer_norm(pair_dim)
        self.single_in = PromotingDense(single_dim, embed_dim)
        self.layer = StructureModuleLayer(embed_dim, num_heads,
                                          pair_dim=pair_dim)

    def forward(self, s, z, mask=None):
        bsz, n_res, _ = s.shape
        s = self.single_in(self.single_norm(s))
        z = self.pair_norm(z)
        rot, trans = identity_rigid((bsz, n_res), s.dtype, s.device)
        for _ in range(self.n_layers):  # one layer, its weights shared
            s, rot, trans = self.layer(s, z, rot, trans, mask)
        return s, (rot, trans), trans
