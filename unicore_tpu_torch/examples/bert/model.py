"""BERT (counterpart of ``examples/bert/model.py``): token + learned
position embeddings, the post-LN (default) or pre-LN encoder with the
bucketed relative-position bias, the tied-weight masked-LM head, and
sentence-level classification heads over the [CLS] position.

The masked-token-only head has a static slot budget
(:meth:`BertModel.slot_count`): the masked positions' indices, then the
unmasked ones, each in ascending order, fill ``K`` slots — what the
reference's ``jax.lax.top_k`` over the 0/1 mask picks, ties resolving low
index first — so only ~mask_prob of the positions pay the vocab
projection.  ``fused_head=True`` returns the head's features with the tied
kernel and bias instead of logits, so the loss can run the projection
chunk by chunk.  Parameter names are the reference torch model's.

flax makes a classification head's parameters at its first call with
``classification_head_name``; a torch module's must exist before that, so
a head is registered first (:meth:`BertModel.register_classification_head`)
into ``classification_heads``, under the reference torch names
(``classification_heads.{name}.dense.weight``, ...).  The architectures
are the JAX package's: ``bert``/``bert_base``, ``bert_large`` and ``xlm``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...models import (BaseUnicoreModel, register_model,
                       register_model_architecture)
from ...modules import FlaxDense, LayerNorm, TransformerEncoder
from ...ops.dropout import bernoulli_dropout
from ...utils import arg_bool, eval_bool, get_activation_fn
from . import convert


class BertLMHead(nn.Module):
    """Masked-LM head over the tied embedding: ``LN(act(dense(x)))``,
    projected by the embedding matrix, plus ``bias``."""

    def __init__(self, embed_dim, output_dim, activation_fn):
        super().__init__()
        self.dense = FlaxDense(embed_dim, embed_dim)
        self.act = get_activation_fn(activation_fn)
        self.layer_norm = LayerNorm(embed_dim)
        self.bias = nn.Parameter(torch.zeros(output_dim))

    def features(self, x):
        return self.layer_norm(self.act(self.dense(x)))

    def forward(self, x, weight):
        return F.linear(self.features(x), weight) + self.bias


class BertClassificationHead(nn.Module):
    """Sentence-level classification head over the [CLS] position:
    dropout, ``dense``, the pooler activation, dropout, ``out_proj``.
    Its dropout is flax's ``nn.Dropout`` (:func:`bernoulli_dropout`),
    drawn from the caller's generator while training."""

    def __init__(self, input_dim, inner_dim, num_classes, activation_fn,
                 pooler_dropout):
        super().__init__()
        self.dense = FlaxDense(input_dim, inner_dim)
        self.activation_fn = get_activation_fn(activation_fn)
        self.pooler_dropout = pooler_dropout
        self.out_proj = FlaxDense(inner_dim, num_classes)

    def _dropout(self, x, generator):
        if not self.training or self.pooler_dropout <= 0.0:
            return x
        return bernoulli_dropout(x, self.pooler_dropout, generator)

    def forward(self, features, generator=None):
        x = self._dropout(features[:, 0, :], generator)  # [CLS]
        x = self._dropout(self.activation_fn(self.dense(x)), generator)
        return self.out_proj(x)


@register_model("bert")
class BertModel(BaseUnicoreModel):
    supports_fused_head = True
    flax_convert = convert

    def __init__(self, vocab_size=30522, padding_idx=0, encoder_layers=12,
                 encoder_embed_dim=768, encoder_ffn_embed_dim=3072,
                 encoder_attention_heads=12, emb_dropout=0.1, dropout=0.1,
                 attention_dropout=0.1, activation_dropout=0.0,
                 max_seq_len=512, activation_fn="gelu", post_ln=True,
                 masked_loss_capacity=0.25, checkpoint_activations=False,
                 pooler_activation_fn="tanh", pooler_dropout=0.0):
        super().__init__()
        self.vocab_size = vocab_size
        self.padding_idx = padding_idx
        self.encoder_layers = encoder_layers
        self.max_seq_len = max_seq_len
        self.masked_loss_capacity = masked_loss_capacity
        self.flax_heads = encoder_attention_heads
        self.embed_tokens = nn.Embedding(vocab_size, encoder_embed_dim)
        self.embed_positions = nn.Embedding(max_seq_len, encoder_embed_dim)
        self.sentence_encoder = TransformerEncoder(
            encoder_layers=encoder_layers, embed_dim=encoder_embed_dim,
            ffn_embed_dim=encoder_ffn_embed_dim,
            attention_heads=encoder_attention_heads, emb_dropout=emb_dropout,
            dropout=dropout, attention_dropout=attention_dropout,
            activation_dropout=activation_dropout, max_seq_len=max_seq_len,
            activation_fn=activation_fn, rel_pos=True, rel_pos_bins=32,
            max_rel_pos=128, post_ln=post_ln,
            checkpoint_activations=checkpoint_activations)
        self.lm_head = BertLMHead(encoder_embed_dim, vocab_size,
                                  activation_fn)
        self.encoder_embed_dim = encoder_embed_dim
        self.pooler_activation_fn = pooler_activation_fn
        self.pooler_dropout = pooler_dropout
        self.classification_heads = nn.ModuleDict()

    def register_classification_head(self, name, num_classes=2):
        """Add the classification head ``name`` (``num_classes`` outputs,
        2 as in the JAX model unless given; inner width the encoder's) on
        the model's device and dtype, initialized as the JAX package
        inits it: normal(0.02) kernels, drawn from a CPU generator seeded
        0, and zero biases.  Returns the head."""
        head = BertClassificationHead(
            self.encoder_embed_dim, self.encoder_embed_dim, num_classes,
            self.pooler_activation_fn, self.pooler_dropout)
        generator = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for proj in (head.dense, head.out_proj):
                proj.weight.normal_(0.0, 0.02, generator=generator)
                proj.bias.zero_()
        ref = self.embed_tokens.weight
        head.to(device=ref.device, dtype=ref.dtype)
        head.train(self.training)
        self.classification_heads[name] = head
        return head

    @staticmethod
    def add_args(parser):
        parser.add_argument("--encoder-layers", type=int, metavar="L",
                            help="num encoder layers")
        parser.add_argument("--encoder-embed-dim", type=int, metavar="H",
                            help="encoder embedding dimension")
        parser.add_argument("--encoder-ffn-embed-dim", type=int, metavar="F",
                            help="encoder embedding dimension for FFN")
        parser.add_argument("--encoder-attention-heads", type=int,
                            metavar="A", help="num encoder attention heads")
        parser.add_argument("--activation-fn",
                            help="activation function to use")
        parser.add_argument("--pooler-activation-fn",
                            help="activation function to use for pooler "
                                 "layer")
        parser.add_argument("--emb-dropout", type=float, metavar="D",
                            help="dropout probability for embeddings")
        parser.add_argument("--dropout", type=float, metavar="D",
                            help="dropout probability")
        parser.add_argument("--attention-dropout", type=float, metavar="D",
                            help="dropout probability for attention weights")
        parser.add_argument("--activation-dropout", type=float, metavar="D",
                            help="dropout probability after activation in "
                                 "FFN")
        parser.add_argument("--pooler-dropout", type=float, metavar="D",
                            help="dropout probability in the masked_lm "
                                 "pooler layers")
        parser.add_argument("--max-seq-len", type=int,
                            help="number of positional embeddings to learn")
        parser.add_argument("--post-ln", type=eval_bool,
                            help="use post layernorm or pre layernorm")
        parser.add_argument("--checkpoint-activations", type=arg_bool,
                            nargs="?", const=True, default=False,
                            help="recompute encoder-layer activations in "
                                 "backward; bare flag or explicit "
                                 "True/False")
        parser.add_argument("--masked-loss-capacity", type=float, metavar="F",
                            help="fraction of tokens given LM-head slots "
                                 "(0 = project every position)")

    @staticmethod
    def slot_count(bsz, seq_len, capacity):
        """Static LM-head slot budget: the capacity fraction of B*T,
        floored at 8, rounded up to a multiple of 128, capped at B*T."""
        k = int(round(bsz * seq_len * capacity))
        k = max(min(k, bsz * seq_len), 8)
        return min(-(-k // 128) * 128, bsz * seq_len)

    @classmethod
    def build_model(cls, args, task):
        capacity = getattr(args, "masked_loss_capacity", None)
        model = cls(
            vocab_size=len(task.dictionary),
            padding_idx=task.dictionary.pad(),
            encoder_layers=args.encoder_layers,
            encoder_embed_dim=args.encoder_embed_dim,
            encoder_ffn_embed_dim=args.encoder_ffn_embed_dim,
            encoder_attention_heads=args.encoder_attention_heads,
            emb_dropout=args.emb_dropout, dropout=args.dropout,
            attention_dropout=args.attention_dropout,
            activation_dropout=args.activation_dropout,
            max_seq_len=args.max_seq_len, activation_fn=args.activation_fn,
            post_ln=args.post_ln,
            pooler_activation_fn=args.pooler_activation_fn,
            pooler_dropout=args.pooler_dropout,
            masked_loss_capacity=0.25 if capacity is None else capacity,
            checkpoint_activations=bool(
                getattr(args, "checkpoint_activations", False)))
        model.reset_parameters(
            torch.Generator().manual_seed(int(getattr(args, "seed", 1))))
        return model

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX package's init, drawn from ``generator``: normal(0.02)
        linear weights, embeddings (padding row zeroed), position table
        and relative-position table; zero biases; unit LayerNorm
        scales."""
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
        self.embed_positions.weight.normal_(0.0, 0.02, generator=generator)
        rel = self.sentence_encoder.relative_attention_bias
        rel.weight.normal_(0.0, 0.02, generator=generator)
        self.lm_head.bias.zero_()

    def slots(self, masked_tokens):
        """``(slot_index, slot_valid)`` of the static-capacity head: the
        masked positions of the flat [B*T] mask in ascending order, then
        the unmasked ones, cut to :meth:`slot_count` slots."""
        bsz, seq_len = masked_tokens.shape
        k = self.slot_count(bsz, seq_len, self.masked_loss_capacity)
        flat = masked_tokens.reshape(-1).to(torch.int32)
        slot_index = torch.argsort(-flat, stable=True)[:k]
        return slot_index, flat[slot_index] > 0

    def forward(self, src_tokens, masked_tokens=None, features_only=False,
                generator=None, fused_head=False,
                classification_head_name=None):
        if classification_head_name is not None:
            features_only = True
        padding_mask = (src_tokens == self.padding_idx).to(torch.int32)
        x = self.embed_tokens(src_tokens)
        x = x + self.embed_positions.weight[:src_tokens.shape[1]].to(x.dtype)
        x = self.sentence_encoder(x, padding_mask=padding_mask,
                                  generator=generator)
        if classification_head_name is not None:
            if classification_head_name not in self.classification_heads:
                raise KeyError(
                    f"no classification head {classification_head_name!r}: "
                    "register_classification_head() makes it first")
            return self.classification_heads[classification_head_name](
                x, generator=generator)
        if features_only:
            return x
        weight = self.embed_tokens.weight
        if masked_tokens is not None and self.masked_loss_capacity > 0:
            slot_index, slot_valid = self.slots(masked_tokens)
            feats = x.reshape(-1, x.shape[-1])[slot_index]
            out = {"slot_index": slot_index, "slot_valid": slot_valid}
            if fused_head:
                out.update(features=self.lm_head.features(feats),
                           kernel=weight, bias=self.lm_head.bias, tied=True)
            else:
                out["logits"] = self.lm_head(feats, weight)
            return out
        if fused_head:
            return {"features": self.lm_head.features(x), "kernel": weight,
                    "bias": self.lm_head.bias, "tied": True}
        return self.lm_head(x, weight)


@register_model_architecture("bert", "bert")
def base_architecture(args):
    args.encoder_layers = getattr(args, "encoder_layers", 12)
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 768)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 3072)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads",
                                           12)
    args.dropout = getattr(args, "dropout", 0.1)
    args.emb_dropout = getattr(args, "emb_dropout", 0.1)
    args.attention_dropout = getattr(args, "attention_dropout", 0.1)
    args.activation_dropout = getattr(args, "activation_dropout", 0.0)
    args.pooler_dropout = getattr(args, "pooler_dropout", 0.0)
    args.max_seq_len = getattr(args, "max_seq_len", 512)
    args.activation_fn = getattr(args, "activation_fn", "gelu")
    args.pooler_activation_fn = getattr(args, "pooler_activation_fn", "tanh")
    args.post_ln = getattr(args, "post_ln", True)


@register_model_architecture("bert", "bert_base")
def bert_base_architecture(args):
    base_architecture(args)


@register_model_architecture("bert", "bert_large")
def bert_large_architecture(args):
    args.encoder_layers = getattr(args, "encoder_layers", 24)
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 1024)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim", 4096)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads",
                                           16)
    base_architecture(args)


@register_model_architecture("bert", "xlm")
def xlm_architecture(args):
    args.encoder_layers = getattr(args, "encoder_layers", 16)
    args.encoder_embed_dim = getattr(args, "encoder_embed_dim", 1280)
    args.encoder_ffn_embed_dim = getattr(args, "encoder_ffn_embed_dim",
                                         1280 * 4)
    args.encoder_attention_heads = getattr(args, "encoder_attention_heads",
                                           16)
    base_architecture(args)
