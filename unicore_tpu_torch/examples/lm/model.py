"""Decoder-only transformer LM (counterpart of ``TransformerLMModel`` in
``examples/lm/model.py``): token embeddings, a pre-LN rotary decoder
stack, and the tied output head ``gelu(LN(x)) @ E.T + out_bias``.

The port carries the decode-capable position scheme only — rotary, with
neither the relative-position bias nor learned absolute positions — which
is what the serve path runs.  Parameter names are the reference torch
model's, so ``arch_flax_params("transformer_lm", state_dict)`` in the JAX
package maps a port state dict straight into its flax tree.  The model
registry waits for the training slice; the two architectures' dims are a
plain dict.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...device import resolve_device
from ...modules import LayerNorm, TransformerDecoder
from ...utils import get_activation_fn

ARCHS = {
    "transformer_lm": dict(
        decoder_layers=6, decoder_embed_dim=512, decoder_ffn_embed_dim=2048,
        decoder_attention_heads=8, max_seq_len=512, activation_fn="gelu",
    ),
    "transformer_lm_base": dict(
        decoder_layers=12, decoder_embed_dim=768, decoder_ffn_embed_dim=3072,
        decoder_attention_heads=12, max_seq_len=512, activation_fn="gelu",
    ),
}


class TransformerLMModel(nn.Module):
    def __init__(self, vocab_size=30522, padding_idx=0, decoder_layers=6,
                 decoder_embed_dim=512, decoder_ffn_embed_dim=2048,
                 decoder_attention_heads=8, max_seq_len=512,
                 activation_fn="gelu"):
        super().__init__()
        self.vocab_size = vocab_size
        self.padding_idx = padding_idx
        self.decoder_layers = decoder_layers
        self.decoder_embed_dim = decoder_embed_dim
        self.decoder_attention_heads = decoder_attention_heads
        self.max_seq_len = max_seq_len
        self.act = get_activation_fn(activation_fn)
        self.embed_tokens = nn.Embedding(vocab_size, decoder_embed_dim)
        self.decoder = TransformerDecoder(
            decoder_layers, decoder_embed_dim, decoder_ffn_embed_dim,
            decoder_attention_heads, activation_fn, rotary=True,
        )
        self.out_layer_norm = LayerNorm(decoder_embed_dim)
        self.out_bias = nn.Parameter(torch.zeros(vocab_size))

    @torch.no_grad()
    def reset_parameters(self, generator):
        """The JAX package's init, drawn from ``generator``: normal(0.02)
        embeddings with the padding row zeroed, normal(0.02) linear
        weights, zero biases, unit LayerNorm scales."""
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
        self.out_bias.zero_()

    def features(self, src_tokens, positions=None, paged=None):
        """Decoder output before the head, [B, T, D].  Without ``paged``
        this is the causal full forward over ``src_tokens``; with it, one
        ragged serve step (``positions`` [B, T], -1 = padded column)."""
        padding_mask = src_tokens == self.padding_idx
        return self.decoder(self.embed_tokens(src_tokens),
                            padding_mask=padding_mask, positions=positions,
                            paged=paged)

    def head(self, x):
        """Tied projection of decoder features to logits."""
        return F.linear(self.act(self.out_layer_norm(x)),
                        self.embed_tokens.weight, self.out_bias)

    def forward(self, src_tokens, positions=None, paged=None):
        return self.head(self.features(src_tokens, positions, paged))


def build_model(arch="transformer_lm_base", *, vocab_size=30522,
                padding_idx=0, seed=0, device="cuda", **overrides):
    """A ``TransformerLMModel`` of architecture ``arch`` (dims from
    :data:`ARCHS`, each overridable), its weights drawn on the CPU from
    ``seed`` — so every device gets the same weights — then moved to
    ``device`` (default the card; raises without one)."""
    dev = resolve_device(device)
    model = TransformerLMModel(vocab_size=vocab_size, padding_idx=padding_idx,
                               **{**ARCHS[arch], **overrides})
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
