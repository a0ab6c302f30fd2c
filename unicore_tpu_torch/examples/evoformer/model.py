"""Evoformer (counterpart of ``examples/evoformer/model.py``): MSA and pair
representations co-refined through Evoformer blocks, a per-pair scalar
regressed from the final pair representation and symmetrized.

The flax model infers its input widths at init; this one takes them from
the task's records (the MSA alphabet and the pair feature bins).  The
structure module (IPA and the backbone update) is not ported:
``--structure-module True`` raises, naming ``ROADMAP.md`` A10, and
``--fp16`` raises, naming A17.
Parameter names follow the flax tree (``blocks.{i}.row_attn.q_proj``,
...), which :mod:`.convert` maps one to one.
"""

import torch
from torch import nn

from ...models import (BaseUnicoreModel, register_model,
                       register_model_architecture)
from ...modules import EvoformerBlock
from ...modules.triangle_attention import (Dense, flax_layer_norm,
                                           reset_evoformer_parameters)
from ...utils import eval_bool
from . import convert


@register_model("evoformer")
class EvoformerModel(BaseUnicoreModel):
    flax_convert = convert

    def __init__(self, msa_features, pair_features, evoformer_layers=2,
                 msa_embed_dim=64, pair_embed_dim=32, msa_attention_heads=4,
                 pair_attention_heads=4, opm_hidden_dim=16, dropout=0.0,
                 triangle_multiplication=True):
        super().__init__()
        self.evoformer_layers = evoformer_layers
        self.msa_embed = Dense(msa_features, msa_embed_dim)
        self.pair_embed = Dense(pair_features, pair_embed_dim)
        self.blocks = nn.ModuleList(
            EvoformerBlock(msa_embed_dim, pair_embed_dim,
                           msa_heads=msa_attention_heads,
                           pair_heads=pair_attention_heads, dropout=dropout,
                           opm_hidden_dim=opm_hidden_dim,
                           use_triangle_multiplication=triangle_multiplication)
            for _ in range(evoformer_layers))
        self.final_norm = flax_layer_norm(pair_embed_dim)
        self.head = Dense(pair_embed_dim, 1)

    @staticmethod
    def add_args(parser):
        parser.add_argument("--evoformer-layers", type=int, metavar="L")
        parser.add_argument("--msa-embed-dim", type=int, metavar="C")
        parser.add_argument("--pair-embed-dim", type=int, metavar="C")
        parser.add_argument("--msa-attention-heads", type=int, metavar="A")
        parser.add_argument("--pair-attention-heads", type=int, metavar="A")
        parser.add_argument("--opm-hidden-dim", type=int, metavar="H")
        parser.add_argument("--dropout", type=float, metavar="D")
        parser.add_argument("--triangle-multiplication", type=eval_bool)
        parser.add_argument("--structure-module", type=eval_bool,
                            help="not ported: raises")
        parser.add_argument("--structure-layers", type=int, metavar="N")

    @classmethod
    def build_model(cls, args, task):
        def arg(name, default):
            v = getattr(args, name, None)
            return default if v is None else v

        if getattr(args, "fp16", False):
            # the reference's flax model promotes its fp32 inputs and so
            # runs in fp32 under --fp16; the port casts them to the
            # compute type, a difference held against it in bf16 only
            raise NotImplementedError(
                "--fp16 with the Evoformer: the reference runs the "
                "Evoformer's activations in fp32 under --fp16, and the "
                "port's cast of the inputs to the compute type is not held "
                "against it in fp16 (ROADMAP.md A17); train it under "
                "--bf16")
        if arg("structure_module", False):
            raise NotImplementedError(
                "--structure-module True: the structure module (IPA and the "
                "backbone update) is not ported yet (ROADMAP.md A10)")
        msa_features, pair_features = task.input_dims()
        model = cls(
            msa_features, pair_features,
            evoformer_layers=args.evoformer_layers,
            msa_embed_dim=args.msa_embed_dim,
            pair_embed_dim=args.pair_embed_dim,
            msa_attention_heads=args.msa_attention_heads,
            pair_attention_heads=args.pair_attention_heads,
            opm_hidden_dim=arg("opm_hidden_dim", 16),
            dropout=arg("dropout", 0.0),
            triangle_multiplication=arg("triangle_multiplication", True))
        reset_evoformer_parameters(
            model, torch.Generator().manual_seed(int(getattr(args, "seed",
                                                             1))))
        return model

    def forward(self, msa, pair, msa_mask=None, pair_mask=None,
                generator=None):
        """``msa`` [B, S, R, A] one-hot rows; ``pair`` [B, R, R, F] ->
        [B, R, R].  The inputs are cast to the parameters' type (the bf16
        compute copy runs in bf16); dropout is on in training mode and
        draws from ``generator``."""
        dtype = self.msa_embed.weight.dtype
        m = self.msa_embed(msa.to(dtype))
        z = self.pair_embed(pair.to(dtype))
        for block in self.blocks:
            m, z = block(m, z, msa_mask, pair_mask, generator)
        out = self.head(self.final_norm(z))[..., 0]
        # distances are symmetric: average the two directed predictions
        return 0.5 * (out + out.transpose(1, 2))


@register_model_architecture("evoformer", "evoformer")
def base_architecture(args):
    args.evoformer_layers = getattr(args, "evoformer_layers", None) or 2
    args.msa_embed_dim = getattr(args, "msa_embed_dim", None) or 64
    args.pair_embed_dim = getattr(args, "pair_embed_dim", None) or 32
    args.msa_attention_heads = getattr(args, "msa_attention_heads",
                                       None) or 4
    args.pair_attention_heads = getattr(args, "pair_attention_heads",
                                        None) or 4


@register_model_architecture("evoformer", "evoformer_base")
def arch_base(args):
    """Uni-Fold-like proportions: 8 blocks, c_m 256, c_z 128, 8 MSA heads
    and 4 pair heads (head dim 32 in both)."""
    args.evoformer_layers = getattr(args, "evoformer_layers", None) or 8
    args.msa_embed_dim = getattr(args, "msa_embed_dim", None) or 256
    args.pair_embed_dim = getattr(args, "pair_embed_dim", None) or 128
    args.msa_attention_heads = getattr(args, "msa_attention_heads",
                                       None) or 8
    args.pair_attention_heads = getattr(args, "pair_attention_heads",
                                        None) or 4
