"""Autoregressive generation for the LM through the dense KV-cache decode
path (counterpart of ``examples/lm/generate.py``).

The cache (:class:`~unicore_tpu_torch.modules.multihead_attention.
DecodeCache`: per-layer cached key/value and the cache index) is passed
through every call and advanced in place, positions drive the rotary or
absolute embeddings, and the prompt prefills in a single call before
single-token steps.  Everything runs under ``torch.no_grad()`` on the
model's device, the model in eval mode.

RIGHT-padded batches are supported: the prefill carries 2-D
per-sequence positions (-1 on pad columns, which park their k/v in the
cache's trash slot), the first logits are read from each row's last
VALID position, and every later step advances each sequence at its own
offset — so the generated continuation of every row is token-identical
to generating it alone.  LEFT/interior padding is refused: a pad
BETWEEN real tokens has no consistent cache slot.

Sampling goes through :mod:`unicore_tpu_torch.serve.sampling` — the
same greedy/temperature/top-k implementation the serve engine uses, with
:mod:`~unicore_tpu_torch.serve.threefry` keys, so a seed gives the JAX
``generate()``'s tokens.
"""

import numpy as np
import torch

from ...modules.multihead_attention import DecodeCache
from ...serve.sampling import sample_token
from ...serve.threefry import split


def init_cache(model, batch_size, max_len):
    """A zeroed decode cache of capacity ``max_len`` (+1 trash slot) for
    ``model``, in its parameters' dtype, on their device."""
    param = next(model.parameters())
    heads = model.decoder_attention_heads
    return DecodeCache.allocate(
        model.decoder_layers, batch_size, max_len, heads,
        model.decoder_embed_dim // heads, param.dtype, param.device)


def _last_logits(model, tokens, positions, cache, last):
    """The model over ``tokens`` through the cache, and the logits of
    column ``last[b]`` of each row (the head runs on those rows only)."""
    x = model.features(tokens, positions=positions, cache=cache)
    rows = torch.arange(x.shape[0], device=x.device)
    return model.head(x[rows, last]), cache


def _prefill(model, cache, prompt):
    t0 = prompt.shape[1]
    positions = torch.arange(t0, device=prompt.device)
    last = torch.full((prompt.shape[0],), t0 - 1, device=prompt.device)
    return _last_logits(model, prompt, positions, cache, last)


def _prefill_ragged(model, cache, prompt, lengths):
    """Right-padded prefill: per-sequence positions (-1 on pad columns)
    and last-valid-column logits."""
    cols = torch.arange(prompt.shape[1], device=prompt.device)[None, :]
    positions = torch.where(cols < lengths[:, None], cols,
                            torch.full_like(cols, -1))
    return _last_logits(model, prompt, positions, cache, lengths - 1)


def _step(model, cache, token, t):
    """One token per row at the shared position ``t`` [1]."""
    zero = torch.zeros_like(token)
    return _last_logits(model, token[:, None], t, cache, zero)


def _step_ragged(model, cache, token, t):
    """``t`` [B]: each sequence's own global position this step."""
    zero = torch.zeros_like(token)
    return _last_logits(model, token[:, None], t[:, None], cache, zero)


def _prompt_lengths(prompt, padding_idx):
    """Valid-prefix lengths of a right-padded batch (host numpy); raises
    on interior/left padding or empty rows (no consistent cache layout
    exists)."""
    valid = np.asarray(prompt) != padding_idx
    lengths = valid.sum(axis=1)
    right_padded = (valid.cumsum(axis=1) == np.minimum(
        np.arange(1, valid.shape[1] + 1)[None, :], lengths[:, None]
    )).all()
    if not right_padded or (lengths == 0).any():
        raise ValueError(
            "generate: prompts must be unpadded or RIGHT-padded "
            "(padding between or before real tokens has no consistent "
            "cache slot, and an all-padding row has nothing to continue)"
        )
    return lengths


@torch.no_grad()
def generate(model, prompt, max_new_tokens, temperature=0.0, rng=None,
             max_len=None, top_k=0):
    """Generate ``max_new_tokens`` continuations of ``prompt`` [B, T0]
    (token ids: a tensor, an array or nested lists).

    ``temperature`` 0 = greedy; otherwise seeded softmax sampling with
    optional ``top_k``, which requires ``rng`` (a
    :mod:`~unicore_tpu_torch.serve.threefry` key, split once before each
    sampled token) — via the serve tier's shared sampling helper, so the
    same seed yields the same tokens here, in ``ServeEngine`` and in the
    JAX package.  Right-padded prompts are continued from each row's own
    last valid token, the generated tokens overwriting the padding;
    returns int64 [B, T0 + max_new_tokens] on the model's device (rows
    of a ragged batch keep trailing padding after their
    ``max_new_tokens`` tokens)."""
    device = next(model.parameters()).device
    host = np.asarray(torch.as_tensor(prompt).cpu(), dtype=np.int64)
    bsz, t0 = host.shape
    capacity = max_len or model.max_seq_len
    lengths = _prompt_lengths(host, model.padding_idx)
    assert int(lengths.max()) + max_new_tokens <= capacity, (
        f"prompt ({int(lengths.max())}) + new tokens ({max_new_tokens}) "
        f"exceeds cache capacity ({capacity})"
    )
    if temperature > 0.0 and rng is None:
        raise ValueError("generate: rng required when temperature > 0")
    ragged = bool((lengths < t0).any())
    was_training = model.training
    model.eval()
    try:
        cache = init_cache(model, bsz, capacity)
        tokens = torch.from_numpy(host).to(device)
        if ragged:
            len_dev = torch.from_numpy(lengths).to(device)
            logit, cache = _prefill_ragged(model, cache, tokens, len_dev)
        else:
            logit, cache = _prefill(model, cache, tokens)
        if rng is not None:
            rng = rng.to(device)
        out = np.concatenate(
            [host, np.full((bsz, max_new_tokens), model.padding_idx,
                           np.int64)], axis=1)
        rows = np.arange(bsz)
        for i in range(max_new_tokens):
            key = None
            if temperature > 0.0:
                rng, key = split(rng)
            tok = sample_token(logit, key=key, temperature=temperature,
                               top_k=top_k)
            out[rows, lengths + i] = tok.cpu().numpy()
            if i + 1 < max_new_tokens:
                if ragged:
                    t = torch.from_numpy(lengths + i).to(device)
                    logit, cache = _step_ragged(model, cache, tok, t)
                else:
                    t = torch.tensor([t0 + i], device=device)
                    logit, cache = _step(model, cache, tok, t)
    finally:
        model.train(was_training)
    return torch.from_numpy(out).to(device)
