"""Inverted dropout with 8-bit keep draws (counterpart of
``unicore_tpu/ops/dropout.py``).

The keep probability quantizes to q/256 (rate 0.1 -> q = 230, an
effective drop rate of 10.16%); survivors scale by the exact 256/q, so
E[dropout(x)] == x.  A rate with no representable q (within 1/512 of 0
or 1) escapes to identity or a full drop at the caller's rate: warned
once per distinct rate, or raised under ``UNICORE_TPU_STRICT_DROPOUT=1``
or ``strict=True``.  The bits come from a ``torch.Generator`` on the
tensor's device, so they are not the JAX package's bits; the rate and the
scale are.  Under data parallelism each rank draws these masks from a
generator of its own (:func:`set_rank_generator`).

:func:`bernoulli_dropout` is flax's ``nn.Dropout`` instead, which the
reference's BERT classification head uses: keep with probability
``1 - rate`` at fp32 resolution, survivors divided by ``1 - rate`` in the
input's type.
"""

import logging
import os

import torch

logger = logging.getLogger(__name__)

_warned_rates = set()

# data parallelism: (the generator every rank shares, this rank's own)
_rank_generator = None


def set_rank_generator(shared, own):
    """Under data parallelism every rank draws the same numbers from the
    generator it passes down (the kernels' seeds, the stochastic
    roundings); the masks drawn here from it come from ``own`` instead,
    this rank's generator, so different ranks drop different elements
    and the shared one stays the same on every rank.  ``None`` undoes
    it."""
    global _rank_generator
    _rank_generator = None if shared is None else (shared, own)


def _drawing(generator):
    if _rank_generator is not None and generator is _rank_generator[0]:
        return _rank_generator[1]
    return generator


def _quantization_escape(rate, q, effect, strict):
    if strict is None:
        strict = os.environ.get("UNICORE_TPU_STRICT_DROPOUT", "") == "1"
    msg = (
        f"dropout rate {rate!r} quantizes to {effect} at the q/256 keep "
        f"resolution (q={q}); the requested rate is not representable — "
        f"use a rate of at least 1/512 from 0 and 1, or the float path"
    )
    if strict:
        raise ValueError(msg)
    key = float(rate)
    if key not in _warned_rates:
        _warned_rates.add(key)
        logger.warning(msg)


def dropout(x, rate, generator, strict=None):
    """Apply inverted dropout to ``x`` (training path; callers gate on
    their own training flag and rate > 0).  ``generator`` lives on
    ``x``'s device."""
    rate = float(rate)
    q = int(round((1.0 - rate) * 256.0))
    if q >= 256:
        if rate > 0.0:
            _quantization_escape(rate, q, "exact identity (no dropout)",
                                 strict)
        return x
    if q <= 0:
        if rate < 1.0:
            _quantization_escape(rate, q, "a full drop (all zeros)", strict)
        return torch.zeros_like(x)
    bits = torch.randint(0, 256, x.shape, generator=_drawing(generator),
                         device=x.device, dtype=torch.uint8)
    return torch.where(bits < q, x * (256.0 / q), torch.zeros((), dtype=x.dtype,
                                                              device=x.device))


def bernoulli_dropout(x, rate, generator):
    """flax's ``nn.Dropout`` (training path): each element kept where a
    uniform fp32 draw from ``generator`` (on ``x``'s device) lies below
    ``1 - rate``, as ``jax.random.bernoulli`` keeps, and the survivors
    divided by ``1 - rate`` taken to ``x``'s dtype, as jnp divides by a
    Python float.  A rate of 0 is the identity and 1 a full drop."""
    rate = float(rate)
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=_drawing(generator),
                      device=x.device) \
        < keep_prob
    scale = torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / scale, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
