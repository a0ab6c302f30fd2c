"""Evoformer (counterpart of ``examples/evoformer/model.py``): MSA and pair
representations co-refined through Evoformer blocks, then either a
per-pair scalar regressed from the final pair representation and
symmetrized, or, under ``--structure-module True``, the pairwise
distances of the C-alpha trace that the structure module (IPA and the
backbone update) folds from the first MSA row and the pair
representation.

The flax model infers its input widths at init; this one takes them from
the task's records (the MSA alphabet and the pair feature bins).
``--fp16`` raises, naming ``ROADMAP.md`` A17.  Parameter names follow
the flax tree (``blocks.{i}.row_attn.q_proj``, ...), which :mod:`.convert`
maps one to one; as in flax, a model with the structure module has no
``final_norm`` and no ``head``.
"""

import torch
from torch import nn

from ...models import (BaseUnicoreModel, register_model,
                       register_model_architecture)
from ...modules import EvoformerBlock, StructureModule
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
                 triangle_multiplication=True, structure_module=False,
                 structure_layers=3):
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
        if structure_module:
            self.structure_module = StructureModule(
                msa_embed_dim, msa_attention_heads, structure_layers,
                pair_dim=pair_embed_dim)
            self.final_norm = self.head = None
        else:
            self.structure_module = None
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
                            help="predict distances geometrically: run the "
                                 "structure module (IPA + backbone update) "
                                 "on the refined single/pair reprs and "
                                 "output pairwise distances of the "
                                 "predicted C-alpha trace")
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
            triangle_multiplication=arg("triangle_multiplication", True),
            structure_module=bool(arg("structure_module", False)),
            structure_layers=arg("structure_layers", 3))
        reset_evoformer_parameters(
            model, torch.Generator().manual_seed(int(getattr(args, "seed",
                                                             1))))
        return model

    def forward(self, msa, pair, msa_mask=None, pair_mask=None,
                generator=None):
        """``msa`` [B, S, R, A] one-hot rows; ``pair`` [B, R, R, F] ->
        [B, R, R].  The inputs are cast to the parameters' type (the bf16
        compute copy runs the trunk in bf16); dropout is on in training
        mode and draws from ``generator``.  The structure module runs in
        fp32 on any weights: its inputs are cast up, and it promotes
        bf16 weights as flax does, so its frames and the distances are
        fp32 as in the reference, which runs the whole model in fp32
        under ``--bf16``."""
        dtype = self.msa_embed.weight.dtype
        m = self.msa_embed(msa.to(dtype))
        z = self.pair_embed(pair.to(dtype))
        for block in self.blocks:
            m, z = block(m, z, msa_mask, pair_mask, generator)
        if self.structure_module is not None:
            # the AlphaFold wiring: the single representation is the first
            # MSA row; the distances are those of the predicted C-alpha
            # trace, so the loss trains through real 3-D geometry
            res_mask = None if msa_mask is None else msa_mask[:, 0]
            _, _, pos = self.structure_module(m[:, 0].float(), z.float(),
                                              res_mask)
            diff = pos[:, :, None, :] - pos[:, None, :, :]
            return torch.sqrt((diff ** 2).sum(-1) + 1e-8)
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
