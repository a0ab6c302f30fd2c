"""Counter-hash dropout bits: the plain version of ``csrc/prng.cuh``.

Counterpart of ``unicore_tpu/ops/pallas/prng.py``: element ``idx`` of a
block drawn under ``seed`` gets ``mix(idx + seed * 0x9E3779B9)``, where
``mix`` is the splitmix32 finalizer, all in uint32 arithmetic.  The bits
are those of the JAX function, bit for bit, negative int32 seeds
included (the seed wraps mod 2^32 before the multiply).

PyTorch has no uint32 arithmetic, so this computes in int64 and masks to
32 bits after every step.  A product of two 32-bit values can pass 2^63,
so each multiply is split in 16-bit halves of the constant.
"""

import torch

MASK32 = 0xFFFFFFFF

# this process's data-parallel rank: the kernels' dropout sites number a
# rank's rows after those of the ranks before it, as the JAX package
# numbers the rows of its global batch
_row_shard = 0


def set_row_shard(rank):
    """Make this process data-parallel rank ``rank``: a seeded dropout
    site then gives its local row i the seed of global row
    ``rank·batch + i``."""
    global _row_shard
    _row_shard = int(rank)


def row_shard():
    return _row_shard
GOLDEN = 0x9E3779B9
MIX1 = 0x21F0AAAD
MIX2 = 0x735A2D97


def _mul32(a, c):
    """``(a * c) mod 2^32`` for int64 ``a`` in [0, 2^32) and a 32-bit
    constant ``c``, without leaving int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def mix(h):
    """splitmix32 finalizer on int64 values in [0, 2^32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, MIX1)
    h = h ^ (h >> 15)
    h = _mul32(h, MIX2)
    return h ^ (h >> 15)


def random_bits(seed, idx):
    """uint32 bits (as int64) of element ``idx`` under ``seed``; both are
    integer tensors (or ints) that broadcast, ``seed`` read as int32."""
    seed = torch.as_tensor(seed, dtype=torch.int64) & MASK32
    idx = torch.as_tensor(idx, dtype=torch.int64) & MASK32
    return mix((idx + _mul32(seed, GOLDEN)) & MASK32)


def draw_seeds(generator, shape):
    """int32 seeds in [0, 2^31 - 1) of ``shape`` from ``generator``, on
    its device (a CUDA generator never syncs with the host) — the range
    the JAX package draws its kernel seeds from."""
    return torch.randint(0, 2 ** 31 - 1, shape, generator=generator,
                         device=generator.device, dtype=torch.int32)


def keep_threshold(keep_prob):
    """The uint32 threshold below which an element is kept, as the JAX
    ``keep_mask`` computes it."""
    return min(int(keep_prob * 4294967296.0), 4294967295)


def block_bits(seed, shape):
    """Bits of a whole block of ``shape`` under scalar ``seed``, indexed
    row-major — ``random_bits(seed, shape)`` of the JAX package."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64).reshape(shape)
    return random_bits(seed, idx)


def keep_mask(seed, shape, keep_prob):
    """Boolean keep mask with P(keep) = keep_prob (JAX ``keep_mask``)."""
    return block_bits(seed, shape) < keep_threshold(keep_prob)
