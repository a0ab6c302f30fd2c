"""Evoformer pair-stack regression model (counterpart of
``examples/pair/model.py``): pair features [B, N, N, F] -> a linear
embed to C -> L ``EvoformerPairBlock``s (triangle multiplicative updates,
triangle attention per row and per column, the pair transition) ->
LayerNorm -> a scalar per pair.

The flax model infers its input width at init; this one takes it from
the task's records (the pair feature bins).  ``--fp16`` raises, naming
``ROADMAP.md`` A17, for the Evoformer's reason.  Parameter names follow
the flax tree (``embed``, ``blocks.{i}``, ``final_norm``, ``head``),
which :mod:`.convert` maps one to one.
"""

import torch
from torch import nn

from ...models import (BaseUnicoreModel, register_model,
                       register_model_architecture)
from ...modules import EvoformerPairBlock
from ...modules.triangle_attention import (Dense, flax_layer_norm,
                                           reset_evoformer_parameters)
from ...utils import eval_bool
from . import convert


@register_model("evoformer_pair")
class EvoformerPairModel(BaseUnicoreModel):
    flax_convert = convert

    def __init__(self, pair_features, pair_layers=4, pair_embed_dim=64,
                 pair_attention_heads=4, dropout=0.0,
                 triangle_multiplication=True):
        super().__init__()
        self.pair_layers = pair_layers
        self.embed = Dense(pair_features, pair_embed_dim)
        self.blocks = nn.ModuleList(
            EvoformerPairBlock(
                pair_embed_dim, pair_attention_heads, dropout=dropout,
                use_triangle_multiplication=triangle_multiplication)
            for _ in range(pair_layers))
        self.final_norm = flax_layer_norm(pair_embed_dim)
        self.head = Dense(pair_embed_dim, 1)

    @staticmethod
    def add_args(parser):
        parser.add_argument("--pair-layers", type=int, metavar="L")
        parser.add_argument("--pair-embed-dim", type=int, metavar="C")
        parser.add_argument("--pair-attention-heads", type=int, metavar="A")
        parser.add_argument("--dropout", type=float, metavar="D")
        parser.add_argument("--triangle-multiplication", type=eval_bool)

    @classmethod
    def build_model(cls, args, task):
        def arg(name, default):
            v = getattr(args, name, None)
            return default if v is None else v

        if getattr(args, "fp16", False):
            # as the Evoformer's: the reference's flax model promotes its
            # fp32 inputs and so runs in fp32 under --fp16
            raise NotImplementedError(
                "--fp16 with the pair model: the reference runs its "
                "activations in fp32 under --fp16, and the port's cast of "
                "the inputs to the compute type is not held against it in "
                "fp16 (ROADMAP.md A17); train it under --bf16")
        model = cls(
            task.input_dims(), pair_layers=args.pair_layers,
            pair_embed_dim=args.pair_embed_dim,
            pair_attention_heads=args.pair_attention_heads,
            dropout=arg("dropout", 0.0),
            triangle_multiplication=arg("triangle_multiplication", True))
        reset_evoformer_parameters(
            model, torch.Generator().manual_seed(int(getattr(args, "seed",
                                                             1))))
        return model

    def forward(self, pair, pair_mask=None, generator=None):
        """``pair`` [B, N, N, F] -> [B, N, N].  The input is cast to the
        parameters' type (the bf16 compute copy runs in bf16); dropout is
        on in training mode and draws from ``generator``."""
        z = self.embed(pair.to(self.embed.weight.dtype))
        for block in self.blocks:
            z = block(z, pair_mask, generator)
        return self.head(self.final_norm(z))[..., 0]


@register_model_architecture("evoformer_pair", "evoformer_pair")
def base_architecture(args):
    args.pair_layers = getattr(args, "pair_layers", None) or 4
    args.pair_embed_dim = getattr(args, "pair_embed_dim", None) or 64
    args.pair_attention_heads = getattr(args, "pair_attention_heads",
                                        None) or 4


@register_model_architecture("evoformer_pair", "evoformer_pair_base")
def base_arch_large(args):
    """12 blocks, c_z 128, 8 heads (head dim 16)."""
    args.pair_layers = getattr(args, "pair_layers", None) or 12
    args.pair_embed_dim = getattr(args, "pair_embed_dim", None) or 128
    args.pair_attention_heads = getattr(args, "pair_attention_heads",
                                        None) or 8
