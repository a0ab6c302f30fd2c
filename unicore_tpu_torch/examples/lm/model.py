"""Decoder-only transformer LM (counterpart of ``TransformerLMModel`` in
``examples/lm/model.py``): token embeddings, learned absolute positions
(``abs_pos``), the causal decoder with the bucketed relative-position
bias (``rel_pos``) or rotary embeddings (``rotary``), pre-LN or post-LN,
and the tied output head ``gelu(LN(x)) @ E.T + out_bias``.
``--checkpoint-activations`` recomputes each decoder layer's activations
in backward; the parameters, and so the checkpoint files, are the same
with and without it.

``unicore-train --task lm --arch transformer_lm[_base]`` builds it from
the command line with the reference's defaults: rel-pos and learned
positions on, unless ``--rotary True`` turns each off that is not given.
Constructed directly (the serve engine, :func:`build_model`), the
defaults are the decode-capable scheme: rotary alone.  Parameter names
are the reference torch model's, so ``arch_flax_params("transformer_lm",
state_dict)`` in the JAX package maps a port state dict straight into its
flax tree.  ``fused_head=True`` returns the head's features with the tied
kernel and bias instead of logits, so the loss runs the vocab projection
chunk by chunk.
"""

import argparse
import logging

import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from ...models import (ARCH_CONFIG_REGISTRY, BaseUnicoreModel,
                       register_model, register_model_architecture)
from ...modules import LayerNorm, TransformerDecoder
from ...utils import arg_bool, eval_bool, get_activation_fn
from . import convert

logger = logging.getLogger(__name__)

# the architecture's fields build_model takes (dropout is off in eval)
ARCH_DIMS = ("decoder_layers", "decoder_embed_dim", "decoder_ffn_embed_dim",
             "decoder_attention_heads", "max_seq_len", "activation_fn")


@register_model("transformer_lm")
class TransformerLMModel(BaseUnicoreModel):
    supports_fused_head = True
    flax_convert = convert

    def __init__(self, vocab_size=30522, padding_idx=0, decoder_layers=6,
                 decoder_embed_dim=512, decoder_ffn_embed_dim=2048,
                 decoder_attention_heads=8, emb_dropout=0.1, dropout=0.1,
                 attention_dropout=0.1, activation_dropout=0.0,
                 max_seq_len=512, activation_fn="gelu", post_ln=False,
                 rel_pos=False, rotary=True, abs_pos=False,
                 checkpoint_activations=False):
        super().__init__()
        self.vocab_size = vocab_size
        self.padding_idx = padding_idx
        self.decoder_layers = decoder_layers
        self.decoder_embed_dim = decoder_embed_dim
        self.decoder_attention_heads = decoder_attention_heads
        self.flax_heads = decoder_attention_heads
        self.max_seq_len = max_seq_len
        self.rel_pos = rel_pos
        self.act = get_activation_fn(activation_fn)
        self.embed_tokens = nn.Embedding(vocab_size, decoder_embed_dim)
        self.embed_positions = (nn.Embedding(max_seq_len, decoder_embed_dim)
                                if abs_pos else None)
        self.decoder = TransformerDecoder(
            decoder_layers=decoder_layers, embed_dim=decoder_embed_dim,
            ffn_embed_dim=decoder_ffn_embed_dim,
            attention_heads=decoder_attention_heads, emb_dropout=emb_dropout,
            dropout=dropout, attention_dropout=attention_dropout,
            activation_dropout=activation_dropout, max_seq_len=max_seq_len,
            activation_fn=activation_fn, rel_pos=rel_pos, post_ln=post_ln,
            rotary=rotary, checkpoint_activations=checkpoint_activations,
        )
        self.out_layer_norm = LayerNorm(decoder_embed_dim)
        self.out_bias = nn.Parameter(torch.zeros(vocab_size))

    @staticmethod
    def add_args(parser):
        parser.add_argument("--decoder-layers", type=int, metavar="L")
        parser.add_argument("--decoder-embed-dim", type=int, metavar="H")
        parser.add_argument("--decoder-ffn-embed-dim", type=int, metavar="F")
        parser.add_argument("--decoder-attention-heads", type=int,
                            metavar="A")
        parser.add_argument("--activation-fn")
        parser.add_argument("--emb-dropout", type=float, metavar="D")
        parser.add_argument("--dropout", type=float, metavar="D")
        parser.add_argument("--attention-dropout", type=float, metavar="D")
        parser.add_argument("--activation-dropout", type=float, metavar="D")
        parser.add_argument("--max-seq-len", type=int)
        # NOT type=bool: bool("False") is True — eval_bool parses the text
        parser.add_argument("--post-ln", type=eval_bool)
        parser.add_argument("--rel-pos", type=eval_bool,
                            help="bucketed T5 rel-pos bias (a [1, H, T, T] "
                                 "table); off by default under --rotary")
        parser.add_argument("--rotary", type=eval_bool,
                            help="rotary position embeddings; the "
                                 "decode-capable scheme")
        parser.add_argument("--abs-pos", type=eval_bool,
                            help="learned absolute position embeddings; "
                                 "off by default under --rotary")
        parser.add_argument("--checkpoint-activations", type=arg_bool,
                            nargs="?", const=True, default=False,
                            help="recompute decoder-layer activations in "
                                 "backward (memory for time); bare flag "
                                 "or explicit True/False")

    @classmethod
    def build_model(cls, args, task):
        model = cls(
            vocab_size=len(task.dictionary),
            padding_idx=task.dictionary.pad(),
            decoder_layers=args.decoder_layers,
            decoder_embed_dim=args.decoder_embed_dim,
            decoder_ffn_embed_dim=args.decoder_ffn_embed_dim,
            decoder_attention_heads=args.decoder_attention_heads,
            emb_dropout=args.emb_dropout, dropout=args.dropout,
            attention_dropout=args.attention_dropout,
            activation_dropout=args.activation_dropout,
            max_seq_len=args.max_seq_len, activation_fn=args.activation_fn,
            post_ln=args.post_ln,
            rel_pos=cls._off_when_rotary(args, "rel-pos"),
            rotary=bool(getattr(args, "rotary", None)),
            abs_pos=cls._off_when_rotary(args, "abs-pos"),
            checkpoint_activations=bool(
                getattr(args, "checkpoint_activations", False)),
        )
        model.reset_parameters(
            torch.Generator().manual_seed(int(getattr(args, "seed", 1))))
        return model

    @staticmethod
    def _off_when_rotary(args, flag):
        """A position-scheme flag's value: as given, else False under
        ``--rotary`` and True without it (the reference's rule)."""
        val = getattr(args, flag.replace("-", "_"), None)
        rotary = bool(getattr(args, "rotary", None))
        if val is None:
            if rotary:
                logger.info("--rotary: defaulting --%s False (pass --%s "
                            "True explicitly to combine both position "
                            "schemes)", flag, flag)
            return not rotary
        if val and rotary and flag == "rel-pos":
            logger.warning("--rotary with --rel-pos True: the quadratic "
                           "[1,H,T,T] rel-pos bias is still built")
        return bool(val)

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX package's init, drawn from ``generator``: normal(0.02)
        embeddings with the padding row zeroed, normal(0.02) linear
        weights, position table and relative-position table, zero biases,
        unit LayerNorm scales."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                module.weight.normal_(0.0, 0.02, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        self.embed_tokens.weight.normal_(0.0, 0.02, generator=generator)
        self.embed_tokens.weight[self.padding_idx] = 0.0
        if self.embed_positions is not None:
            self.embed_positions.weight.normal_(0.0, 0.02,
                                                generator=generator)
        rel = self.decoder.relative_attention_bias
        if rel is not None:
            rel.weight.normal_(0.0, 0.02, generator=generator)
        self.out_bias.zero_()

    def features(self, src_tokens, positions=None, paged=None,
                 generator=None, cache=None):
        """Decoder output before the head, [B, T, D].  Without ``paged``
        or ``cache`` this is the causal full forward over ``src_tokens``;
        with ``paged``, one ragged serve step (``positions`` [B, T], -1 =
        padded column); with ``cache`` (a :class:`~unicore_tpu_torch.
        modules.multihead_attention.DecodeCache`), one dense-cache decode
        step (``positions`` [T], or [B, T] with -1 = inactive), the cache
        advanced in place."""
        padding_mask = src_tokens == self.padding_idx
        x = self.embed_tokens(src_tokens)
        if self.embed_positions is not None:
            pos = self.embed_positions.weight
            if positions is None:
                x = x + pos[:src_tokens.shape[1]].to(x.dtype)
            else:
                # -1 marks an inactive column: gather row 0 for it
                x = x + pos[positions.long().clamp(min=0)].to(x.dtype)
        return self.decoder(x, padding_mask=padding_mask, generator=generator,
                            positions=positions, paged=paged, cache=cache)

    def head_features(self, x):
        """The head's features before the tied projection."""
        return self.act(self.out_layer_norm(x))

    def head(self, x):
        """Tied projection of decoder features to logits: the product
        rounds to x's dtype, then the bias adds (``embed.attend(x) +
        bias``)."""
        return F.linear(self.head_features(x), self.embed_tokens.weight) \
            + self.out_bias

    def forward(self, src_tokens, positions=None, paged=None, generator=None,
                fused_head=False, cache=None):
        """Logits [B, T, V]; with ``cache``, ``(logits, cache)`` as the
        JAX model's ``apply(..., mutable=["cache"])`` returns them."""
        x = self.features(src_tokens, positions, paged, generator, cache)
        if cache is not None:
            return self.head(x), cache
        if fused_head:
            return {"features": self.head_features(x),
                    "kernel": self.embed_tokens.weight,
                    "bias": self.out_bias, "tied": True}
        return self.head(x)


@register_model_architecture("transformer_lm", "transformer_lm")
def base_lm_architecture(args):
    args.decoder_layers = getattr(args, "decoder_layers", 6)
    args.decoder_embed_dim = getattr(args, "decoder_embed_dim", 512)
    args.decoder_ffn_embed_dim = getattr(args, "decoder_ffn_embed_dim", 2048)
    args.decoder_attention_heads = getattr(args, "decoder_attention_heads", 8)
    args.dropout = getattr(args, "dropout", 0.1)
    args.emb_dropout = getattr(args, "emb_dropout", 0.1)
    args.attention_dropout = getattr(args, "attention_dropout", 0.1)
    args.activation_dropout = getattr(args, "activation_dropout", 0.0)
    args.max_seq_len = getattr(args, "max_seq_len", 512)
    args.activation_fn = getattr(args, "activation_fn", "gelu")
    args.post_ln = getattr(args, "post_ln", False)


@register_model_architecture("transformer_lm", "transformer_lm_base")
def lm_base_architecture(args):
    args.decoder_layers = getattr(args, "decoder_layers", 12)
    args.decoder_embed_dim = getattr(args, "decoder_embed_dim", 768)
    args.decoder_ffn_embed_dim = getattr(args, "decoder_ffn_embed_dim", 3072)
    args.decoder_attention_heads = getattr(args, "decoder_attention_heads", 12)
    base_lm_architecture(args)


def build_model(arch="transformer_lm_base", *, vocab_size=30522,
                padding_idx=0, seed=0, device="cuda", **overrides):
    """A rotary ``TransformerLMModel`` of architecture ``arch`` (its
    registered dims, each overridable), its weights drawn on the CPU from
    ``seed`` — so every device gets the same weights — then moved to
    ``device`` (default the card; raises without one), in eval mode."""
    dev = resolve_device(device)
    args = argparse.Namespace()
    ARCH_CONFIG_REGISTRY[arch](args)
    dims = {k: getattr(args, k) for k in ARCH_DIMS}
    model = TransformerLMModel(vocab_size=vocab_size, padding_idx=padding_idx,
                               **{**dims, **overrides})
    model.reset_parameters(torch.Generator().manual_seed(int(seed)))
    return model.to(dev).eval()


@torch.no_grad()
def solo_greedy(model, prompt, max_new_tokens, eos_id=None):
    """The serve engine's oracle: greedy decode of one request alone by
    the full causal forward, recomputed over the whole prefix each step.
    Returns ``(tokens, margins)`` — ``margins[i]`` is the gap between the
    top two logits at step ``i`` (how far that step is from a tie)."""
    device = next(model.parameters()).device
    toks = torch.tensor([list(prompt)], dtype=torch.long, device=device)
    out, margins = [], []
    for _ in range(max_new_tokens):
        logits = model(toks)[0, -1].float()
        top2 = torch.topk(logits, 2).values
        nxt = int(torch.argmax(logits))
        out.append(nxt)
        margins.append(float(top2[0] - top2[1]))
        if eos_id is not None and nxt == eos_id:
            break
        toks = torch.cat([toks, toks.new_tensor([[nxt]])], dim=1)
    return out, margins
