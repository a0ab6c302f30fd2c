"""The part of ``jax.random`` that the JAX package's sampling uses, in
torch integer ops (counterpart of the threefry PRNG that
``unicore_tpu/serve/sampling.py`` draws from).

This copies jax 0.9.0's Threefry-2x32 with ``jax_threefry_partitionable``
on (jax's default), so a key, a fold, a split, the bits and every draw
built on them equal ``jax.random``'s bit for bit:

- ``PRNGKey(s)`` is the word pair ``(s >> 32, s & 0xFFFFFFFF)``;
- ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
- ``split(k, n)``'s key ``i`` is ``threefry2x32(k, (i >> 32, i &
  0xFFFFFFFF))``, both output words kept;
- ``random_bits(k, shape)`` is the XOR of the two output words over the
  flat index ``i`` of each element as the counter pair;
- ``uniform`` puts the top 23 bits in an fp32 mantissa of [1, 2) and
  subtracts 1; ``gumbel`` is ``-log(-log(u))`` over ``uniform`` on
  ``[tiny, 1)``; ``categorical`` is ``argmax(gumbel + logits)``.

The log is the one XLA compiles ``jnp.log`` to for an x86 CPU with FMA
(Eigen's ``plog_float``: the Cephes polynomial, whose multiply-adds
LLVM fuses), not ``torch.log``, which differs from it in the last bit on
many draws: :func:`xla_log` gives its bits on any device.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words.  Leading
key dimensions are a batch of keys: each draws its own ``shape``, so
``random_bits(keys [B, 2], (V,))`` is ``[B, V]``, as ``jax.vmap`` over
the keys gives.  The words are computed in int64 masked to 32 bits, so
the same code runs on the CPU and on CUDA, on the device of the key.
jax computes all of this in XLA, outside any Pallas kernel, and so does
the port: plain torch ops.
"""

import numpy as np
import torch

from ..utils import fma_fp32

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)
# Cephes' log polynomial and ln 2 split in two, as fp32 values
_LOG_P = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
          -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
          0.2000071406364441, -0.24999994039535522, 0.3333333134651184)
_LOG_Q1, _LOG_Q2 = -0.00021219444170128554, 0.693359375
_SQRT_HALF = 0.7071067690849304


def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of counter words ``(x0, x1)`` under key
    words ``(k0, k1)`` (int64 tensors of uint32 values that broadcast
    together): 5 groups of 4 rounds, the key injected after each group
    with the group index + 1 added.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _MASK
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & _MASK
    return x0, x1


def PRNGKey(seed, device=None):
    """``jax.random.PRNGKey(seed)``: an int, or an integer tensor of
    seeds (a batch of keys ``[..., 2]``).  Seeds lie in [0, 2**32) or,
    for an int, anywhere in int64."""
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    return torch.stack([(seed >> 32) & _MASK, seed & _MASK], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in(key, data)`` for ``data`` an int or an
    integer tensor that broadcasts against the key's batch."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1],
                          torch.zeros_like(data), data & _MASK)
    return torch.stack([y0, y1], dim=-1)


def _counters(key, shape):
    """The key words shaped to broadcast over ``shape`` after the key's
    batch, and the flat element index of ``shape`` as a counter pair."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    idx = torch.arange(n, dtype=torch.int64, device=key.device).view(shape)
    lead = key.shape[:-1] + (1,) * len(shape)
    return (key[..., 0].reshape(lead), key[..., 1].reshape(lead),
            idx >> 32, idx & _MASK)


def split(key, n=2):
    """``jax.random.split(key, n)``: ``[n, 2]`` keys (``[..., n, 2]``
    for a batch of keys)."""
    y0, y1 = threefry2x32(*_counters(key, (n,)))
    return torch.stack([y0, y1], dim=-1)


def random_bits(key, shape):
    """``jax.random.bits(key, shape)`` as int64 values of uint32 words,
    ``key.shape[:-1] + shape``."""
    y0, y1 = threefry2x32(*_counters(key, shape))
    return y0 ^ y1


def _uniform01(bits):
    """The top 23 bits as the mantissa of an fp32 in [1, 2), minus 1."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return one - 1.0


def uniform(key, shape, minval=0.0):
    """``jax.random.uniform(key, shape, minval=minval)`` on ``[minval,
    1)``, fp32: ``u * (1 - minval) + minval`` (``minval`` rounded to fp32
    first), then at least ``minval``."""
    floats = _uniform01(random_bits(key, shape))
    lo = torch.full((), minval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (1.0 - lo) + lo)


def _fma(a, b, c):
    """fp32 ``a * b + c`` rounded once (``b``, ``c`` tensors or fp32
    values)."""
    if not isinstance(c, torch.Tensor):  # a fill, not a host copy
        c = torch.full((), c, dtype=torch.float32, device=a.device)
    return fma_fp32(a, b, c)


def xla_log(x):
    """``jnp.log`` of positive normal fp32 ``x`` as XLA computes it on
    an x86 CPU with FMA, bit for bit: Eigen's ``plog_float`` with the
    fused multiply-adds its compiled loop has (each ``_fma`` below is one
    ``vfmadd``; ``*`` and ``+`` round on their own)."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 127).float() + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(torch.float32)
    small = m < _SQRT_HALF  # mantissa in [0.5, sqrt(0.5)): use 2m
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.float()
    p = _LOG_P
    x2 = x * x
    x3 = x2 * x
    y = _fma(_fma(torch.full_like(x, p[0]), x, p[1]), x, p[2])
    y1 = _fma(_fma(torch.full_like(x, p[3]), x, p[4]), x, p[5])
    y2 = _fma(_fma(torch.full_like(x, p[6]), x, p[7]), x, p[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    x = _fma(x2, -0.5, x) + y
    return _fma(e, _LOG_Q2, x)


def gumbel(key, shape):
    """``jax.random.gumbel(key, shape)`` (its default "low" mode), fp32:
    ``-log(-log(u))`` of a uniform on ``[tiny, 1)``, with
    :func:`xla_log`."""
    return -xla_log(-xla_log(uniform(key, shape, minval=_TINY)))


def categorical(key, logits):
    """``jax.random.categorical(key, logits)``: the argmax of ``gumbel +
    logits`` over the last axis (ties to the first index, as
    ``jnp.argmax``), for fp32 ``logits``.  A single key draws a gumbel
    for every element of ``logits``; a batch of keys ``[B, 2]`` draws row
    b of ``logits [B, ...]`` from key b, as ``jax.vmap`` over the keys
    does.  Returns int64."""
    noise = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(noise + logits, dim=-1)
