"""Uni-Mol 3-D molecular transformer (counterpart of
``examples/mol/model.py``): atom embeddings through the shared
:class:`~unicore_tpu_torch.modules.TransformerEncoder`, every layer's
attention steered by a per-batch pair bias ``[B, H, N, N]`` computed from
interatomic distances — a Gaussian basis expansion with a per-edge-type
affine, projected to one bias per head.  A per-batch bias is not flash's
(which takes a batch-broadcast one), so every layer takes the
materialized attention: ``softmax_dropout`` with the bias, its kernels on
the card when N is a multiple of 128 (``--max-atoms 128`` or ``256``).

Heads: tied-embedding masked-atom logits, a distance delta off the
(noisy) input distances, and an equivariant coordinate update.

Types follow the reference under the trainers' compute copy (fp16 or
bf16 parameters, the batch not cast): the coordinates, distances and
Gaussian features stay fp32, the edge-type affine and the feature
projections promote to fp32 (:class:`~unicore_tpu_torch.modules.FlaxDense`
promotes as flax does), the bias is cast to the compute type once and
re-read by every layer; the encoder and the atom head run in the compute
type; the pair head divides by ``sqrt(D)`` rounded to its type first, and
its concat with the fp32 features promotes to fp32.  Parameter names
follow the flax tree, which :mod:`.convert` maps.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...models import (BaseUnicoreModel, register_model,
                       register_model_architecture)
from ...modules import FlaxDense, LayerNorm, TransformerEncoder
from ...utils import get_activation_fn, rounded_constant
from . import convert


class GaussianBasis(nn.Module):
    """Distance -> radial features, calibrated per atom-pair type:
    ``phi_k(d; t) = exp(-0.5 ((mul_t d + bias_t - mean_k) / std_k)^2)``
    with learned centers and widths; K kernels over [0, span] Angstroms
    at init."""

    def __init__(self, n_kernels=32, n_edge_types=1, span=12.0):
        super().__init__()
        self.span = span
        self.means = nn.Parameter(torch.empty(n_kernels))
        self.stds = nn.Parameter(torch.empty(n_kernels))
        self.mul = nn.Embedding(n_edge_types, 1)
        self.bias = nn.Embedding(n_edge_types, 1)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self):
        k = self.means.shape[0]
        self.means.copy_(torch.linspace(0.0, self.span, k))
        self.stds.fill_(self.span / k)
        self.mul.weight.fill_(1.0)
        self.bias.weight.zero_()

    def forward(self, dist, edge_type):
        mul = self.mul(edge_type)[..., 0]
        bias = self.bias(edge_type)[..., 0]
        x = (mul * dist + bias)[..., None]  # dist's fp32, whatever mul's
        std = torch.clamp(self.stds.abs(),
                          min=rounded_constant(1e-3, self.stds.dtype))
        return torch.exp(-0.5 * torch.square((x - self.means) / std))


class AtomHead(nn.Module):
    """Masked-atom logits through the tied embedding: ``LN(act(dense(x)))
    @ W_embed^T + bias``, the product rounded before the bias adds."""

    def __init__(self, embed_dim, vocab_size, activation_fn):
        super().__init__()
        self.dense = FlaxDense(embed_dim, embed_dim)
        self.act = get_activation_fn(activation_fn)
        self.norm = LayerNorm(embed_dim)
        self.bias = nn.Parameter(torch.zeros(vocab_size))

    def forward(self, x, weight):
        x = self.norm(self.act(self.dense(x)))
        return F.linear(x, weight) + self.bias


@register_model("unimol")
class UniMolModel(BaseUnicoreModel):
    flax_convert = convert

    def __init__(self, vocab_size=16, pad_idx=0, encoder_layers=6,
                 embed_dim=256, ffn_embed_dim=1024, attention_heads=8,
                 pair_hidden_dim=32, gaussian_kernels=32, max_atoms=32,
                 dropout=0.1, attention_dropout=0.1, activation_fn="gelu"):
        super().__init__()
        self.vocab_size = vocab_size
        self.pad_idx = pad_idx
        self.encoder_layers = encoder_layers
        self.attention_heads = attention_heads
        self.pair_hidden_dim = pair_hidden_dim
        self.head_dim = embed_dim // attention_heads
        self.flax_heads = attention_heads
        self.act = get_activation_fn(activation_fn)
        k, p = gaussian_kernels, pair_hidden_dim
        self.gbf = GaussianBasis(k, vocab_size * vocab_size)
        self.gbf_proj_in = FlaxDense(k, k)
        self.gbf_proj_out = FlaxDense(k, attention_heads)
        self.embed_tokens = nn.Embedding(vocab_size, embed_dim)
        self.encoder = TransformerEncoder(
            encoder_layers=encoder_layers, embed_dim=embed_dim,
            ffn_embed_dim=ffn_embed_dim, attention_heads=attention_heads,
            emb_dropout=dropout, dropout=dropout,
            attention_dropout=attention_dropout, max_seq_len=max_atoms,
            activation_fn=activation_fn, rel_pos=False)
        self.lm_head = AtomHead(embed_dim, vocab_size, activation_fn)
        self.pair_q = FlaxDense(embed_dim, p * self.head_dim)
        self.pair_k = FlaxDense(embed_dim, p * self.head_dim)
        self.pair_mlp = FlaxDense(p + k, p)
        self.dist_head = FlaxDense(p, 1)
        self.coord_head = FlaxDense(p, 1)

    @staticmethod
    def add_args(parser):
        parser.add_argument("--encoder-layers", type=int, metavar="L")
        parser.add_argument("--encoder-embed-dim", type=int, metavar="E")
        parser.add_argument("--encoder-ffn-embed-dim", type=int, metavar="F")
        parser.add_argument("--encoder-attention-heads", type=int,
                            metavar="H")
        parser.add_argument("--pair-hidden-dim", type=int, metavar="P")
        parser.add_argument("--gaussian-kernels", type=int, metavar="K")
        parser.add_argument("--dropout", type=float, metavar="D")
        parser.add_argument("--attention-dropout", type=float, metavar="D")
        parser.add_argument("--activation-fn", type=str)

    @classmethod
    def build_model(cls, args, task):
        model = cls(
            vocab_size=len(task.dictionary),
            pad_idx=task.dictionary.pad(),
            encoder_layers=args.encoder_layers,
            embed_dim=args.encoder_embed_dim,
            ffn_embed_dim=args.encoder_ffn_embed_dim,
            attention_heads=args.encoder_attention_heads,
            pair_hidden_dim=args.pair_hidden_dim,
            gaussian_kernels=args.gaussian_kernels,
            max_atoms=args.max_atoms,
            dropout=getattr(args, "dropout", 0.1) or 0.0,
            attention_dropout=getattr(args, "attention_dropout", 0.1) or 0.0,
            activation_fn=getattr(args, "activation_fn", None) or "gelu")
        model.reset_parameters(
            torch.Generator().manual_seed(int(getattr(args, "seed", 1))))
        return model

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX package's init, drawn from ``generator``: normal(0.02)
        projection kernels and token embedding, zero biases, unit
        LayerNorm scales, the Gaussian basis's own init."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                module.weight.normal_(0.0, 0.02, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        self.embed_tokens.weight.normal_(0.0, 0.02, generator=generator)
        self.gbf.reset_parameters()
        self.lm_head.bias.zero_()

    def forward(self, src_tokens, src_coord, generator=None):
        """``src_tokens`` [B, N], ``src_coord`` [B, N, 3] -> ``{"logits"
        [B, N, V], "pred_coord" [B, N, 3], "pred_dist" [B, N, N]}``.
        Dropout is on in training mode and draws from ``generator``."""
        bsz, n = src_tokens.shape
        real = src_tokens != self.pad_idx
        padding_mask = (~real).float()

        # pairwise geometry (eps keeps the sqrt's gradient finite on the
        # diagonal)
        delta = src_coord[:, :, None, :] - src_coord[:, None, :, :]
        dist = torch.sqrt(torch.square(delta).sum(-1) + 1e-8)
        edge_type = (src_tokens[:, :, None] * self.vocab_size
                     + src_tokens[:, None, :])
        phi = self.gbf(dist, edge_type)
        attn_bias = self.gbf_proj_out(self.act(self.gbf_proj_in(phi)))
        # zero the bias wherever either end is padding (padded keys are
        # masked again by the key padding)
        pair_real = real[:, :, None] & real[:, None, :]
        attn_bias = torch.where(pair_real[..., None], attn_bias, 0.0)
        # [B, H, N, N], rows contiguous as the softmax_dropout kernel reads
        # them: one copy here, not one a layer
        attn_bias = attn_bias.permute(0, 3, 1, 2).contiguous()

        x = self.encoder(self.embed_tokens(src_tokens), attn_mask=attn_bias,
                         padding_mask=padding_mask, generator=generator)
        logits = self.lm_head(x, self.embed_tokens.weight)

        # pair representation from the final states: one bilinear einsum
        # plus the radial features
        p, d = self.pair_hidden_dim, self.head_dim
        qp = self.pair_q(x).reshape(bsz, n, p, d)
        kp = self.pair_k(x).reshape(bsz, n, p, d)
        # jnp.sqrt(float(D)): an fp32 constant rounded to the array's type
        pair = torch.einsum("biph,bjph->bijp", qp, kp) / rounded_constant(
            float(np.sqrt(np.float32(d))), qp.dtype)
        dtype = torch.promote_types(pair.dtype, phi.dtype)
        pair = torch.cat([pair.to(dtype), phi.to(dtype)], dim=-1)
        pair = self.act(self.pair_mlp(pair))
        pair = 0.5 * (pair + pair.transpose(1, 2))  # symmetric

        pred_dist = dist + self.dist_head(pair)[..., 0]
        # equivariant coordinate head: displacements weighted by a learned
        # pair scalar
        w = self.coord_head(pair)[..., 0]
        w = w * pair_real.to(w.dtype)
        n_real = torch.clamp(real.to(w.dtype).sum(-1), min=1.0)[:, None, None]
        update = ((w / n_real)[..., None] * delta).sum(2)
        return {"logits": logits, "pred_coord": src_coord + update,
                "pred_dist": pred_dist}


@register_model_architecture("unimol", "unimol")
def unimol_tiny(args):
    args.encoder_layers = getattr(args, "encoder_layers", None) or 6
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", None) or 256
    args.encoder_ffn_embed_dim = (
        getattr(args, "encoder_ffn_embed_dim", None) or 1024)
    args.encoder_attention_heads = (
        getattr(args, "encoder_attention_heads", None) or 8)
    args.pair_hidden_dim = getattr(args, "pair_hidden_dim", None) or 32
    args.gaussian_kernels = getattr(args, "gaussian_kernels", None) or 32


@register_model_architecture("unimol", "unimol_base")
def unimol_base(args):
    """The published Uni-Mol backbone scale (15 x 512, 64 heads of 8)."""
    args.encoder_layers = getattr(args, "encoder_layers", None) or 15
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", None) or 512
    args.encoder_ffn_embed_dim = (
        getattr(args, "encoder_ffn_embed_dim", None) or 2048)
    args.encoder_attention_heads = (
        getattr(args, "encoder_attention_heads", None) or 64)
    args.pair_hidden_dim = getattr(args, "pair_hidden_dim", None) or 64
    args.gaussian_kernels = getattr(args, "gaussian_kernels", None) or 128
