"""Flash attention of the PyTorch port (unicore_tpu_torch/ops/
flash_attention.py, csrc/flash_attention.cu, csrc/prng.cuh) against the
JAX package: the counter-hash bits of ``ops/prng.py`` vs the JAX
``random_bits``/``keep_mask`` bit for bit, and the plain flash forward and
backward vs the Pallas ``_flash`` run in interpret mode on the same
per-row seeds — so with dropout on, agreement within the tolerances is
itself the proof that the two draw the same masks.  Where a card is
present, the CUDA kernels vs the plain version.

fp32, B = 2.  Tolerances as tests/test_flash_attention.py: forward atol
2e-5, grads atol 5e-4 (both sides exact fp32, summation order differs).
The JAX side is imported inside the tests, so that the card-only cases
can run where JAX is not installed."""

import numpy as np
import pytest
import torch

from unicore_tpu_torch.ops import flash_attention as fa
from unicore_tpu_torch.ops import prng

FWD_ATOL, GRAD_ATOL = 2e-5, 5e-4
SEEDS = [0, 1, 7, 12345, -1, -2, -1640531527, 2 ** 31 - 1, -2 ** 31]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_bits_equal_jax(seed):
    import jax.numpy as jnp

    from unicore_tpu.ops.pallas import prng as jprng

    shape = (3, 5, 7)
    want = np.asarray(jprng.random_bits(jnp.int32(seed), shape))
    got = prng.block_bits(seed, shape).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    for keep_prob in (0.9, 0.5, 1.0):
        want = np.asarray(jprng.keep_mask(jnp.int32(seed), shape, keep_prob))
        got = prng.keep_mask(seed, shape, keep_prob).numpy()
        np.testing.assert_array_equal(got, want)


def test_row_seeds_wrap_as_int32():
    """The public function's per-row seeds: base + row * -1640531527,
    wrapped to int32 as the reference's int32 arithmetic wraps."""
    gen = torch.Generator().manual_seed(3)
    base = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gen,
                             dtype=torch.int64))
    got = fa.row_seeds(torch.Generator().manual_seed(3), 5, "cpu").numpy()
    with np.errstate(over="ignore"):
        want = (np.int32(base) + np.arange(5, dtype=np.int32)
                * np.int32(-1640531527))
    np.testing.assert_array_equal(got, want)


def make_case(rng, B, T, H, D, bias_kind, pad_kind):
    q, k, v, w = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(4))
    bias = None
    if bias_kind is not None:
        bias = rng.randn(*{"full": (1, H, T, T), "heads1": (1, 1, T, T),
                           "row": (1, H, 1, T)}[bias_kind]).astype(np.float32)
    pad = None
    if pad_kind is not None:
        pad = np.zeros((B, T), np.int32)
        pad[0, -T // 4:] = 1
        if pad_kind == "all_row":
            pad[1, :] = 1  # every key of row 1 padded: uniform average
    seed = np.array([rng.randint(-2 ** 31, 2 ** 31 - 1) for _ in range(B)],
                    dtype=np.int32)
    return q, k, v, w, bias, pad, seed


def jax_flash(case, p, causal, scale):
    """out [B, T, H, D] and grads (q, k, v[, bias]) of sum(out * w) through
    the Pallas ``_flash`` in interpret mode."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.ops.backend import kernel_backend
    from unicore_tpu.ops.pallas import flash_attention as jfa

    q, k, v, w, bias, pad, seed = case
    tr = lambda x: jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))  # noqa: E731
    pad_j = None if pad is None else jnp.asarray(pad)[:, None, :]
    wt = tr(w)

    def f(qt, kt, vt, b):
        out = jfa._flash(qt, kt, vt, b, pad_j, p, jnp.asarray(seed), causal,
                         scale)
        return jnp.sum(out * wt), out

    args = (tr(q), tr(k), tr(v), None if bias is None else jnp.asarray(bias))
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    with kernel_backend("pallas"):
        (_, out), grads = jax.value_and_grad(f, argnums=argnums,
                                             has_aux=True)(*args)
    back = lambda x: np.asarray(jnp.transpose(x, (0, 2, 1, 3)))  # noqa
    grads = [back(g) for g in grads[:3]] + [np.asarray(g) for g in grads[3:]]
    return back(out), grads


def port_flash(case, p, causal, scale, device="cpu", dtype=torch.float32):
    q, k, v, w, bias, pad, seed = case
    ts = [torch.tensor(x, dtype=dtype, device=device, requires_grad=True)
          for x in (q, k, v)]
    bt = None
    if bias is not None:
        bt = torch.tensor(bias, dtype=dtype, device=device,
                          requires_grad=True)
    pt = None if pad is None else torch.from_numpy(pad).to(device)
    out = fa.flash(*ts, bt, pt, p, torch.from_numpy(seed).to(device), causal,
                   scale)
    (out.float() * torch.from_numpy(w).to(device)).sum().backward()
    grads = [t.grad for t in ts] + ([] if bt is None else [bt.grad])
    return (out.detach().float().cpu().numpy(),
            [g.float().cpu().numpy() for g in grads])


CASES = {
    # name: (H, D, bias kind, pad kind, causal, dropout)
    "bias_full": (4, 64, "full", None, False, 0.0),
    "bias_full_pad_drop": (2, 32, "full", "tail", False, 0.1),
    "bias_heads1_pad_drop": (3, 16, "heads1", "all_row", False, 0.1),
    "bias_row_pad": (2, 64, "row", "all_row", False, 0.0),
    "bias_row_drop": (4, 16, "row", None, False, 0.1),
    "causal_drop": (2, 32, None, None, True, 0.1),
    "causal_bias_pad": (2, 16, "full", "tail", True, 0.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_flash(name):
    H, D, bias_kind, pad_kind, causal, p = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    case = make_case(rng, 2, 128, H, D, bias_kind, pad_kind)
    scale = D ** -0.5
    want_out, want_grads = jax_flash(case, p, causal, scale)
    got_out, got_grads = port_flash(case, p, causal, scale)
    np.testing.assert_allclose(got_out, want_out, atol=FWD_ATOL, rtol=0)
    for gname, g, w in zip("q k v bias".split(), got_grads, want_grads):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=gname)


def test_multiblock_mask_geometry_matches_jax(monkeypatch):
    """T = 256 with both packages' block pick pinned to (128, 128): the
    dropout seeds run over a 2 x 2 block grid, (h·n_i + i)·n_j + j, and the
    index is block-local — the multi-block reference path."""
    import unicore_tpu.ops.pallas.flash_attention as jfa

    monkeypatch.setattr(jfa, "_pick_blocks",
                        lambda tq, tk, bias_itemsize=0: (128, 128))
    monkeypatch.setattr(fa, "pick_blocks",
                        lambda tq, tk, bias_itemsize=0: (128, 128))
    rng = np.random.RandomState(11)
    case = make_case(rng, 2, 256, 2, 32, "full", "tail")
    want_out, want_grads = jax_flash(case, 0.1, False, 32 ** -0.5)
    got_out, got_grads = port_flash(case, 0.1, False, 32 ** -0.5)
    np.testing.assert_allclose(got_out, want_out, atol=FWD_ATOL, rtol=0)
    for gname, g, w in zip("q k v bias".split(), got_grads, want_grads):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=gname)


def test_geometry_follows_the_reference_pick():
    """At BERT's T = 512 the reference takes one block for an fp32 and a
    bf16 bias alike, so the mask of (b, h) is one T x T block under seed
    seed[b] + h."""
    from unicore_tpu.ops.pallas.flash_attention import _pick_blocks

    for tq, tk, item in ((512, 512, 4), (512, 512, 2), (512, 512, 0),
                         (1024, 1024, 4), (2048, 2048, 2), (384, 768, 0)):
        assert fa.pick_blocks(tq, tk, item) == _pick_blocks(tq, tk, item)
    assert fa.pick_blocks(512, 512, 4) == (512, 512)
    seed = torch.tensor([5, -9], dtype=torch.int32)
    mask = fa.keep_mask(seed, 3, 512, 512, (512, 512), 0.9)
    for b in range(2):
        for h in range(3):
            want = prng.keep_mask(int(seed[b]) + h, (512, 512), 0.9)
            assert torch.equal(mask[b, h], want)


def test_public_function_dropout_draws_from_generator(rng):
    q, k, v = (torch.from_numpy(rng.randn(2, 128, 2, 16).astype(np.float32))
               for _ in range(3))
    run = lambda s: fa.flash_attention(  # noqa: E731
        q, k, v, dropout_prob=0.2, generator=torch.Generator().manual_seed(s))
    assert torch.equal(run(4), run(4))
    assert not torch.allclose(run(4), run(5))
    off = fa.flash_attention(q, k, v, dropout_prob=0.2, is_training=False)
    assert not torch.allclose(run(4), off)
    with pytest.raises(ValueError, match="generator"):
        fa.flash_attention(q, k, v, dropout_prob=0.2)
    with pytest.raises(ValueError, match="tq == tk"):
        fa.flash_attention(q, k[:, :64], v[:, :64], causal=True)


def test_eligibility_rules_copy_the_reference():
    from unicore_tpu.ops.pallas.flash_attention import eligible

    shapes = [((2, 4, 256, 64), (2, 4, 256, 64), None),
              ((2, 4, 256, 64), (2, 4, 256, 64), (1, 4, 256, 256)),
              ((2, 4, 256, 64), (2, 4, 256, 64), (2, 4, 256, 256)),
              ((2, 4, 200, 64), (2, 4, 200, 64), None),
              ((2, 4, 256, 264), (2, 4, 256, 264), None),
              ((2, 4, 256, 64), (2, 4, 256, 64), (1, 1, 1, 256))]
    for s in shapes:
        assert fa.eligible(*s) == eligible(*s), s


def test_library_name_digests_included_headers(tmp_path, monkeypatch):
    """An edited header must never load a stale library: the library's
    name digests the source and every ``csrc/`` header it includes, and
    only the sources that include the header change name."""
    import shutil

    from unicore_tpu_torch.ops import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert [p.name for p in build.sources("flash_attention")] == [
        "flash_attention.cu", "prng.cuh"]
    flash, paged = (build.library_path(n)
                    for n in ("flash_attention", "paged_attention"))
    header = csrc / "prng.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert build.library_path("flash_attention") != flash
    assert build.library_path("paged_attention") == paged


def test_package_data_ships_every_kernel_source():
    """An installed package needs the headers beside the ``.cu`` files."""
    import fnmatch
    import os
    import re

    from unicore_tpu_torch.ops import build

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "setup.py")) as f:
        shipped = re.search(r'"unicore_tpu_torch": \[([^]]*)\]',
                            f.read()).group(1)
    globs = re.findall(r'"([^"]+)"', shipped)
    for path in build.CSRC.iterdir():
        rel = f"csrc/{path.name}"
        assert any(fnmatch.fnmatch(rel, g) for g in globs), rel


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bias_full_pad_drop", "bias_heads1_pad_drop",
                                  "bias_row_pad", "causal_drop", "d128"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(cuda, name, dtype):
    """The CUDA kernels (forward, dk/dv, dq, dbias) vs the plain version
    on the same values, T = 256 (four 64-row tiles a side, two reference
    blocks when pinned): fp32 within 1e-4 (out) and 1e-3 of each grad's
    max; bf16 against the plain version in fp32 on the same bf16 values
    within 2e-2 of each tensor's max."""
    H, D, bias_kind, pad_kind, causal, p = CASES.get(
        name, (2, 128, "full", "tail", False, 0.1))
    rng = np.random.RandomState(5)
    case = make_case(rng, 3, 256, H, D, bias_kind, pad_kind)
    dt = getattr(torch, dtype)
    # the plain version sees the same (rounded) values in fp32
    case = tuple(None if x is None or x.dtype != np.float32 else
                 torch.from_numpy(x).to(dt).float().numpy() for x in case[:5]
                 ) + case[5:]
    before = dict(fa.launches)
    got_out, got_grads = port_flash(case, p, causal, D ** -0.5, cuda, dt)
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] == before["flash_fwd"] + 1
    assert fa.launches["flash_dq"] == before["flash_dq"] + 1
    assert fa.launches["flash_dkdv"] == before["flash_dkdv"] + 1
    assert fa.launches["flash_dbias"] == (
        before["flash_dbias"] + (bias_kind is not None))
    want_out, want_grads = port_flash(case, p, causal, D ** -0.5)
    tol_out = 1e-4 if dtype == "float32" else 2e-2 * np.abs(want_out).max()
    np.testing.assert_allclose(got_out, want_out, atol=tol_out, rtol=0)
    for gname, g, w in zip("q k v bias".split(), got_grads, want_grads):
        rel = 1e-3 if dtype == "float32" else 2e-2
        np.testing.assert_allclose(g, w, atol=rel * np.abs(w).max(), rtol=0,
                                   err_msg=gname)


@pytest.mark.gpu
def test_ineligible_shapes_raise_on_card(cuda):
    q = torch.zeros(1, 100, 2, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="eligible shapes only"):
        fa.flash_attention(q, q, q)
