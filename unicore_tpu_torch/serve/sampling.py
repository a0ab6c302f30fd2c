"""Seeded token selection, shared by the serve engine and
``examples/lm/generate.py`` (counterpart of
``unicore_tpu/serve/sampling.py``): ONE implementation of
greedy/temperature/top-k, so both paths emit identical tokens for
identical (logits, seed, params) — and the JAX package's tokens, since
the keys and draws are :mod:`.threefry`'s, bit for bit ``jax.random``'s.

Two entry points for the two calling shapes:

- :func:`sample_token` — scalar sampling params (``generate()``):
  ``temperature <= 0`` is a Python-level branch straight to argmax;
- :func:`sample_tokens` — per-row ``temperature``/``top_k``/key tensors
  (the serve engine's step, where every batch row is a different request
  with its own sampling config).  Greedy rows are a ``torch.where``
  select; top-k thresholds are per-row gathers from the sorted logits.

Determinism contract: requests carry an integer ``seed``; step ``i`` of
a request samples with ``fold_in(PRNGKey(seed), i)``.  A preempted and
re-prefilled request resumes at the same fold index, so eviction can
never change the sampled continuation.  Everything runs on the logits'
device; every quotient is a tensor over a tensor there, one rounding as
jnp divides (CUDA computes a tensor over a CPU scalar as a product with
its reciprocal: two).
"""

import torch

from .threefry import PRNGKey, categorical, fold_in


def step_keys(seeds, steps):
    """The per-step sampling keys ``fold_in(PRNGKey(seed), step)`` (the
    JAX ``step_key``, and ``step_keys`` over rows): ``[B]`` integer
    seed/step tensors give ``[B, 2]`` keys on the tensors' device, ints
    one key."""
    return fold_in(PRNGKey(seeds), steps)


def finite_rows(logits):
    """Per-row health of the logits a token is sampled from: bool [B],
    False where ANY entry of the row is NaN/Inf.  The engine quarantines
    such a row on the host while the rest of the batch continues."""
    return torch.isfinite(logits.float()).all(dim=-1)


def greedy_tokens(logits):
    """Argmax per row, int64 [B]; ties go to the first index, as
    ``jnp.argmax``."""
    return torch.argmax(logits.float(), dim=-1)


def _top_k_mask(logits, top_k):
    """Mask logits below each row's k-th largest value.  ``top_k`` is a
    per-row integer tensor; 0 (or >= vocab) disables the filter for that
    row: sort descending once, gather the threshold at index k-1 per
    row."""
    vocab = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    k = torch.where((top_k <= 0) | (top_k >= vocab),
                    torch.full_like(top_k, vocab), top_k)
    thresh = torch.gather(sorted_desc, -1, (k - 1)[..., None].long())
    return torch.where(logits < thresh,
                       torch.full_like(logits, float("-inf")), logits)


def sample_tokens(logits, keys, temperature, top_k, use_top_k=True):
    """Batched per-row sampling: ``logits`` [B, V], ``keys`` [B, 2],
    ``temperature`` [B] fp32 (<= 0 -> greedy), ``top_k`` [B] (0 -> off),
    all on one device.  Returns int64 [B].

    ``use_top_k`` False skips the full-vocab sort when the caller knows
    no row filters (the serve engine checks its live requests): a
    ``top_k = 0`` row samples identically either way."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    floor = torch.tensor(1e-6, dtype=torch.float32, device=logits.device)
    temp = torch.maximum(temperature.float(), floor)[:, None]
    filtered = (_top_k_mask(logits, top_k) if use_top_k else logits) / temp
    sampled = categorical(keys, filtered)
    return torch.where(temperature > 0.0, sampled, greedy)


def sample_token(logits, key=None, temperature=0.0, top_k=0):
    """Scalar-parameter sampling for [..., V] logits (``generate()``'s
    shape): a Python greedy branch, shared top-k masking otherwise, one
    key for every row.  Returns int64 [...]."""
    logits = logits.float()
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    if key is None:
        raise ValueError("sampling with temperature > 0 requires a key")
    if top_k and top_k > 0:
        k = torch.full(logits.shape[:-1], int(top_k), dtype=torch.int64,
                       device=logits.device)
        logits = _top_k_mask(logits, k)
    temp = torch.tensor(float(temperature), dtype=torch.float32,
                        device=logits.device)
    return categorical(key.to(logits.device), logits / temp)
