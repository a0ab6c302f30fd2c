"""Stochastic rounding of the PyTorch port (unicore_tpu_torch/ops/
rounding.py, csrc/rounding.cu) against the JAX package's Pallas kernel
(``unicore_tpu.ops.pallas.rounding.fp32_to_bf16_sr``, run in interpret
mode on the CPU): bit for bit, compared as int16 views, for the seed the
JAX function draws from its key.  Where a card is present, the CUDA
kernel vs the plain version, bit for bit.

The JAX side is imported inside the tests, so that the card-only cases
can run where JAX is not installed."""

import numpy as np
import pytest
import torch

from unicore_tpu_torch.ops import rounding

SPECIALS = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0,
                     3.4e38, -3.4e38, 1e-40, -1e-40], np.float32)


def make_values(n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n) * np.exp(rng.randn(n) * 4)).astype(np.float32)
    x[:len(SPECIALS)] = SPECIALS[:n]
    return x


def jax_sr(x, key_seed):
    """(bf16 bits as int16, the int32 seed the JAX function drew)."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.ops.pallas import rounding as jr

    key = jax.random.PRNGKey(key_seed)
    out = jr.fp32_to_bf16_sr(jnp.asarray(x), key)
    seed = int(jax.random.randint(key, (1,), 0, 2 ** 31 - 1,
                                  dtype=jnp.int32)[0])
    return np.asarray(out).view(np.int16), seed


# (shape, expected r_blk): small and odd sizes take blocks of 8 rows;
# 256 (padded) rows take blocks of 256
CASES = {
    "tiny": ((7,), 8),
    "odd_2d": ((33, 97), 8),
    "rows_not_256": ((300_001,), 8),
    "rows_256_exact": ((256, 1024), 256),
    "rows_256_padded": ((262_140,), 256),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_equals_jax_kernel_bit_for_bit(name):
    shape, r_blk = CASES[name]
    n = int(np.prod(shape))
    assert rounding.pick_layout(n)[1] == r_blk
    x = make_values(n, sorted(CASES).index(name)).reshape(shape)
    want, seed = jax_sr(x, 11 + len(name))
    got = rounding.fp32_to_bf16_sr(torch.from_numpy(x), seed)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)


def test_specials_and_negative_seeds():
    """NaN keeps its sign as a quiet NaN, ±Inf and NaNs whose payload sits
    in the low bits pass as the reference's convert gives them, and a
    negative seed wraps as the reference's int32 arithmetic does."""
    from unicore_tpu.ops.pallas.prng import random_bits
    import jax.numpy as jnp

    odd = np.frombuffer(np.array([0x7F800001, 0xFF800001, 0x7F810000,
                                  0xFFC12345], np.uint32).tobytes(),
                        np.float32)
    x = np.concatenate([SPECIALS, odd])
    got = rounding.fp32_to_bf16_sr(torch.from_numpy(x), -7)
    bits = got.view(torch.int16).numpy().view(np.uint16)
    assert list(bits[:4]) == [0x7FC0, 0xFFC0, 0x7F80, 0xFF80]
    assert list(bits[-4:]) == [0x7F80, 0xFF80, 0x7FC0, 0xFFC0]
    # the noise of element i under seed -7 is the JAX block bits
    noise = np.asarray(random_bits(jnp.int32(-7), (8, 1024))).reshape(-1)
    finite = np.isfinite(x)
    want = ((x.view(np.uint32)[finite].astype(np.uint64)
             + (noise[:len(x)][finite] & 0xFFFF)) >> 16).astype(np.uint16)
    np.testing.assert_array_equal(bits[finite], want)


def test_out_argument_and_mean_is_unbiased():
    x = torch.full((1 << 16,), 1.0 + 2 ** -9)  # between two bf16 values
    out = torch.empty(x.shape, dtype=torch.bfloat16)
    res = rounding.fp32_to_bf16_sr(x, 3, out=out)
    assert res is out
    vals = out.float()
    lo, hi = 1.0, 1.0 + 2 ** -7
    assert set(vals.unique().tolist()) == {lo, hi}
    # P(hi) = 1/4; the mean lies within 4 sigma of x
    sigma = (hi - lo) * np.sqrt(0.25 * 0.75 / x.numel())
    assert abs(float(vals.double().mean()) - (1.0 + 2 ** -9)) < 4 * sigma


# ragged leaves: (elements, seed); r_blk 8 but for 262,144 (256)
RAGGED = ((1, -1), (7, 2 ** 31 - 2), (1023, -2 ** 31), (1025, 17),
          (262_144, -987_654), (1_000_003, 123_456_789))


def ragged_leaves():
    """fp32 leaves of the RAGGED sizes, NaN, ±Inf and ±0 at each one's
    start, and their int32 seeds."""
    xs = []
    for k, (n, _) in enumerate(RAGGED):
        x = make_values(n, 100 + k)
        x[:6] = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, -np.nan],
                         np.float32)[:n]
        xs.append(torch.from_numpy(x))
    return xs, torch.tensor([s for _, s in RAGGED], dtype=torch.int32)


def test_multi_plain_equals_jax_kernel_per_leaf(monkeypatch):
    """One table of ragged leaves, negative seeds included, rounds each
    leaf bit for bit as the JAX Pallas kernel (interpret mode) rounds it
    alone under that leaf's seed (handed to the JAX function in place of
    the seed it would draw from its key)."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.ops.pallas import rounding as jr

    xs, seeds = ragged_leaves()
    outs = [torch.empty(x.shape, dtype=torch.bfloat16) for x in xs]
    assert rounding.fp32_to_bf16_sr_multi(xs, seeds, outs) is outs
    for x, seed, out in zip(xs, seeds.tolist(), outs):
        monkeypatch.setattr(jax.random, "randint", lambda *a, s=seed, **k:
                            jnp.array([s], jnp.int32))
        want = np.asarray(jr.fp32_to_bf16_sr(jnp.asarray(x.numpy()), None))
        np.testing.assert_array_equal(out.view(torch.int16).numpy(),
                                      want.view(np.int16))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_plain_on_card(cuda, name):
    shape, _ = CASES[name]
    x = torch.from_numpy(make_values(int(np.prod(shape)), 5).reshape(shape))
    seed = torch.tensor([-123456], dtype=torch.int32)
    before = rounding.launches["fp32_to_bf16_sr"]
    got = rounding.fp32_to_bf16_sr(x.to(cuda), seed.to(cuda))
    torch.cuda.synchronize()
    assert rounding.launches["fp32_to_bf16_sr"] == before + 1
    want = rounding.fp32_to_bf16_sr_plain(x, seed)
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("aligned", [True, False])
def test_table_kernel_equals_per_leaf_plain_on_card(cuda, aligned):
    """The ragged leaves in one launch, bit for bit the per-leaf plain
    version; unaligned views (4 bytes off) take the kernel's element by
    element path."""
    xs, seeds = ragged_leaves()
    off = 0 if aligned else 1

    def on_card(n, dtype):
        return torch.empty(n + off, dtype=dtype, device=cuda)[off:]

    dev = [on_card(x.numel(), torch.float32).copy_(x) for x in xs]
    outs = [on_card(x.numel(), torch.bfloat16) for x in xs]
    before = rounding.launches["fp32_to_bf16_sr"]
    rounding.fp32_to_bf16_sr_multi(dev, seeds.to(cuda), outs)
    torch.cuda.synchronize()
    assert rounding.launches["fp32_to_bf16_sr"] == before + 1
    for x, seed, out in zip(xs, seeds, outs):
        want = rounding.fp32_to_bf16_sr_plain(x, seed)
        assert torch.equal(out.cpu().view(torch.int16),
                           want.view(torch.int16))


@pytest.mark.gpu
def test_table_of_many_chunks_on_card(cuda):
    """More entries than one launch takes: one launch per capacity's
    worth, every leaf bit for bit the per-leaf plain version, an empty
    leaf skipped."""
    rng = np.random.RandomState(7)
    n_leaves = 2 * rounding.capacity() + 5
    sizes = rng.randint(1, 3000, size=n_leaves)
    sizes[3] = 0
    xs = [torch.from_numpy(make_values(int(n), k)) for k, n in
          enumerate(sizes)]
    seeds = torch.from_numpy(rng.randint(-2 ** 31, 2 ** 31 - 1,
                                         size=n_leaves).astype(np.int32))
    outs = [torch.empty(x.shape, dtype=torch.bfloat16, device=cuda)
            for x in xs]
    before = rounding.launches["fp32_to_bf16_sr"]
    rounding.fp32_to_bf16_sr_multi([x.to(cuda) for x in xs], seeds.to(cuda),
                                   outs)
    torch.cuda.synchronize()
    assert rounding.launches["fp32_to_bf16_sr"] == before + 3
    for x, seed, out in zip(xs, seeds, outs):
        want = rounding.fp32_to_bf16_sr_plain(x, seed)
        assert torch.equal(out.cpu().view(torch.int16),
                           want.view(torch.int16))
