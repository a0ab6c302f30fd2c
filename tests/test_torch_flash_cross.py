"""The port's flash attention at Tq != Tk (cross-attention's call,
unicore_tpu_torch/ops/flash_attention.py) against the JAX package: the
plain forward and backward against the Pallas ``_flash`` in interpret
mode on the same per-row seeds, and the keep masks at the reference's
geometry for (Tq, Tk) against the JAX counter-hash masks bit for bit.
Tiny sizes (B = 3, H = 2-3, D = 16-32)."""

import numpy as np
import pytest
import torch

from unicore_tpu_torch.ops import flash_attention as fa


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def padding(bsz, tk, all_row=False):
    """[B, Tk] int mask: row 0 a quarter of its keys padded at the tail;
    with ``all_row`` row 1 wholly padded."""
    pad = np.zeros((bsz, tk), np.int32)
    pad[0, tk - tk // 4:] = 1
    if all_row:
        pad[1] = 1
    return pad


def cross_case(rng, bsz, tq, tk, heads, d, bias_kind, all_row):
    q, w = (rng.randn(bsz, tq, heads, d).astype(np.float32)
            for _ in range(2))
    k, v = (rng.randn(bsz, tk, heads, d).astype(np.float32)
            for _ in range(2))
    bias = None
    if bias_kind is not None:
        bias = rng.randn(*{"full": (1, heads, tq, tk),
                           "row": (1, heads, 1, tk)}[bias_kind]).astype(
            np.float32)
    pad = padding(bsz, tk, all_row=all_row)
    seed = np.array([rng.randint(-2 ** 31, 2 ** 31 - 1)
                     for _ in range(bsz)], np.int32)
    return q, k, v, w, bias, pad, seed


def jax_flash(case, p, scale, dtype):
    """out and grads (q, k, v[, bias]) of sum(out * w) through the Pallas
    ``_flash`` in interpret mode, as tests/test_torch_flash_attention.py
    runs it."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.ops.backend import kernel_backend
    from unicore_tpu.ops.pallas import flash_attention as jfa

    q, k, v, w, bias, pad, seed = case
    dt = getattr(jnp, dtype)
    tr = lambda x: jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))  # noqa: E731
    wt = tr(w)

    def f(qt, kt, vt, b):
        out = jfa._flash(qt, kt, vt, b, jnp.asarray(pad)[:, None, :], p,
                         jnp.asarray(seed), False, scale)
        return jnp.sum(out.astype(jnp.float32) * wt), out

    args = (tr(q).astype(dt), tr(k).astype(dt), tr(v).astype(dt),
            None if bias is None else jnp.asarray(bias).astype(dt))
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    with kernel_backend("pallas"):
        (_, out), grads = jax.value_and_grad(f, argnums=argnums,
                                             has_aux=True)(*args)
    back = lambda x: np.asarray(  # noqa: E731
        jnp.transpose(x, (0, 2, 1, 3)).astype(jnp.float32))
    return back(out), [back(g) for g in grads[:3]] + [
        np.asarray(g.astype(jnp.float32)) for g in grads[3:]]


def port_flash(case, p, scale, dtype):
    q, k, v, w, bias, pad, seed = case
    ts = [torch.tensor(x, dtype=dtype, requires_grad=True) for x in (q, k, v)]
    bt = None if bias is None else torch.tensor(bias, dtype=dtype,
                                                requires_grad=True)
    out = fa.flash(*ts, bt, torch.from_numpy(pad), p, torch.from_numpy(seed),
                   False, scale)
    (out.float() * torch.from_numpy(w)).sum().backward()
    grads = [t.grad for t in ts] + ([] if bt is None else [bt.grad])
    return out.detach().float().numpy(), [g.float().numpy() for g in grads]


FLASH_CASES = {
    # name: (tq, tk, heads, d, bias kind, all-padded row, blocks pinned)
    "q128_k256_full": (128, 256, 2, 32, "full", True, None),
    "q256_k128_row": (256, 128, 3, 16, "row", False, None),
    "q128_k256_two_key_blocks": (128, 256, 2, 32, "full", False, (128, 128)),
    "q256_k128_two_query_blocks": (256, 128, 2, 16, None, True, (128, 128)),
}


@pytest.mark.parametrize("name,dtype", [
    (n, "float32") for n in sorted(FLASH_CASES)] + [
    ("q128_k256_full", "bfloat16"), ("q128_k256_two_key_blocks", "float16")])
def test_plain_flash_at_tq_ne_tk_matches_jax_flash(name, dtype, monkeypatch):
    """Dropout 0.1 on the same per-row seeds, encoder padding (a wholly
    padded row: the reference's p = 1 in the backward) and a bias:
    agreement is the proof that both draw the same masks.  Pinned
    (128, 128) blocks put two key or two query blocks in the reference's
    geometry (its multi-block kernels).  fp32 within 2e-5 (out) and 5e-4
    (grads), as the square cases; bf16 and fp16 each tensor within 1e-2
    and 1e-3 of its max."""
    tq, tk, heads, d, bias_kind, all_row, pinned = FLASH_CASES[name]
    if pinned is not None:
        import unicore_tpu.ops.pallas.flash_attention as jfa

        for mod, attr in ((jfa, "_pick_blocks"), (fa, "pick_blocks")):
            monkeypatch.setattr(mod, attr,
                                lambda tq, tk, bias_itemsize=0: pinned)
    case = cross_case(np.random.RandomState(sorted(FLASH_CASES).index(name)),
                      3, tq, tk, heads, d, bias_kind, all_row)
    scale = d ** -0.5
    want_out, want_grads = jax_flash(case, 0.1, scale, dtype)
    got_out, got_grads = port_flash(case, 0.1, scale, getattr(torch, dtype))
    fp32 = dtype == "float32"
    rel = 1e-2 if dtype == "bfloat16" else 1e-3
    np.testing.assert_allclose(
        got_out, want_out, rtol=0,
        atol=2e-5 if fp32 else rel * np.abs(want_out).max())
    for gname, g, w in zip("q k v bias".split(), got_grads, want_grads):
        np.testing.assert_allclose(
            g, w, rtol=0, err_msg=gname,
            atol=5e-4 if fp32 else rel * np.abs(w).max())


@pytest.mark.parametrize("tq,tk,bias_itemsize", [
    (256, 512, 2), (128, 1024, 0), (512, 128, 4), (128, 4096, 4)])
def test_keep_mask_at_tq_ne_tk_equals_jax(tq, tk, bias_itemsize):
    """The keep mask at the reference's geometry for (Tq, Tk) equals the
    JAX counter-hash mask block by block, bit for bit: block (h, i, j)
    of batch row b draws under seed[b] + (h·n_i + i)·n_j + j at the
    block-local index.  (128, 4096) with a 4-byte bias has two key
    blocks of 2,048 (the multi-block kernels)."""
    import jax.numpy as jnp

    from unicore_tpu.ops.pallas import flash_attention as jfa
    from unicore_tpu.ops.pallas import prng as jprng

    heads = 2
    seed = torch.tensor([7, -1640531527], dtype=torch.int32)
    geom = fa.pick_blocks(tq, tk, bias_itemsize)
    assert geom == jfa._pick_blocks(tq, tk, bias_itemsize)
    bq, bk = geom
    n_i, n_j = tq // bq, tk // bk
    mask = fa.keep_mask(seed, heads, tq, tk, geom, 0.9).numpy()
    for b in range(2):
        for h in range(heads):
            for i in range(n_i):
                for j in range(n_j):
                    s = (int(seed[b]) + (h * n_i + i) * n_j + j) % 2 ** 32
                    want = np.asarray(jprng.keep_mask(jnp.uint32(s),
                                                      (bq, bk), 0.9))
                    np.testing.assert_array_equal(
                        mask[b, h, i * bq:(i + 1) * bq,
                             j * bk:(j + 1) * bk], want)
