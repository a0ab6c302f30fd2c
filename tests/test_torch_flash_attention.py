"""Flash attention of the PyTorch port (unicore_tpu_torch/ops/
flash_attention.py, csrc/flash_attention.cu, csrc/flash_attention_fwd.cu,
csrc/flash_attention_bwd.cu, csrc/mma_bf16.cuh, csrc/flash_params.cuh,
csrc/prng.cuh) against the JAX package: the counter-hash bits of
``ops/prng.py`` vs the JAX ``random_bits``/``keep_mask`` bit for bit,
and the plain flash forward and backward vs the
Pallas ``_flash`` run in interpret mode on the same per-row seeds — so
with dropout on, agreement within the tolerances is itself the proof that
the two draw the same masks.  The host side of the bf16 kernels (the
parameter struct, shared memory, the batch groups, the dbias partials) on
the CPU; where a card is present, the CUDA kernels vs the plain version.

fp32, B = 2.  Tolerances as tests/test_flash_attention.py: forward atol
2e-5, grads atol 5e-4 (both sides exact fp32, summation order differs).
The same cases in fp16 (the ``--fp16`` path) and the rounding cases in
bf16 and fp16 hold each tensor within a stated share of its max.
The JAX side is imported inside the tests, so that the card-only cases
can run where JAX is not installed."""

import numpy as np
import pytest
import torch

from torch_threads import one_thread_module  # noqa: F401
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
    """``T``: the length of queries and keys, or ``(Tq, Tk)``."""
    Tq, Tk = (T, T) if isinstance(T, int) else T
    q, k, v, w = (rng.randn(B, t, H, D).astype(np.float32)
                  for t in (Tq, Tk, Tk, Tq))
    bias = None
    if bias_kind is not None:
        bias = rng.randn(*{"full": (1, H, Tq, Tk), "heads1": (1, 1, Tq, Tk),
                           "row": (1, H, 1, Tk)}[bias_kind]).astype(
            np.float32)
    pad = None
    if pad_kind is not None:
        pad = np.zeros((B, Tk), np.int32)
        pad[0, -Tk // 4:] = 1
        if pad_kind == "all_row":
            pad[1, :] = 1  # every key of row 1 padded: uniform average
        elif pad_kind == "head":
            pad[1, :Tk // 4] = 1  # under causal, row 1's first queries
            # admit only padded keys
    seed = np.array([rng.randint(-2 ** 31, 2 ** 31 - 1) for _ in range(B)],
                    dtype=np.int32)
    return q, k, v, w, bias, pad, seed


def jax_flash(case, p, causal, scale, dtype="float32"):
    """out [B, T, H, D] and grads (q, k, v[, bias]) of sum(out * w) through
    the Pallas ``_flash`` in interpret mode, q/k/v and bias in ``dtype``;
    returned as fp32 numpy arrays."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.ops.backend import kernel_backend
    from unicore_tpu.ops.pallas import flash_attention as jfa

    q, k, v, w, bias, pad, seed = case
    dt = getattr(jnp, dtype)
    tr = lambda x: jnp.transpose(jnp.asarray(x), (0, 2, 1, 3))  # noqa: E731
    pad_j = None if pad is None else jnp.asarray(pad)[:, None, :]
    wt = tr(w)

    def f(qt, kt, vt, b):
        out = jfa._flash(qt, kt, vt, b, pad_j, p, jnp.asarray(seed), causal,
                         scale)
        return jnp.sum(out.astype(jnp.float32) * wt), out

    args = (tr(q).astype(dt), tr(k).astype(dt), tr(v).astype(dt),
            None if bias is None else jnp.asarray(bias).astype(dt))
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    with kernel_backend("pallas"):
        (_, out), grads = jax.value_and_grad(f, argnums=argnums,
                                             has_aux=True)(*args)
    back = lambda x: np.asarray(  # noqa: E731
        jnp.transpose(x, (0, 2, 1, 3)).astype(jnp.float32))
    grads = [back(g) for g in grads[:3]] + [
        np.asarray(g.astype(jnp.float32)) for g in grads[3:]]
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
    # the LM's training call: causal, a [1, H, T, T] rel-pos bias, tail
    # padding and dropout; and a bias shared by the heads
    "causal_bias_pad_drop": (2, 32, "full", "tail", True, 0.1),
    "causal_bias_heads1": (3, 16, "heads1", "tail", True, 0.1),
}


def _by_dtype(names, dtypes):
    """Cases ``(name, dtype)``; the first dtype keeps the bare name as its
    id, the others append theirs."""
    return [pytest.param(n, dt, id=str(n) if dt == dtypes[0] else f"{n}-{dt}")
            for dt in dtypes for n in names]


@pytest.mark.parametrize("name,dtype",
                         _by_dtype(sorted(CASES), ("float32", "float16")))
def test_plain_matches_jax_flash(name, dtype):
    """fp32 within FWD_ATOL / GRAD_ATOL.  fp16 (q, k, v and the bias in
    fp16 on both sides, the ``--fp16`` path): each tensor within 1e-3 of
    its max, two fp16 ulps there (measured: at most 2.4e-4; the fp32 sums
    run in another order and an fp16 last bit may cross)."""
    H, D, bias_kind, pad_kind, causal, p = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    case = make_case(rng, 2, 128, H, D, bias_kind, pad_kind)
    scale = D ** -0.5
    want_out, want_grads = jax_flash(case, p, causal, scale, dtype)
    got_out, got_grads = port_flash(case, p, causal, scale,
                                    dtype=getattr(torch, dtype))
    fp32 = dtype == "float32"
    np.testing.assert_allclose(
        got_out, want_out, rtol=0,
        atol=FWD_ATOL if fp32 else 1e-3 * np.abs(want_out).max())
    for gname, g, w in zip("q k v bias".split(), got_grads, want_grads):
        np.testing.assert_allclose(
            g, w, rtol=0, err_msg=gname,
            atol=GRAD_ATOL if fp32 else 1e-3 * np.abs(w).max())


@pytest.mark.parametrize("pad_kind", ["head", "all_row"])
def test_plain_matches_jax_flash_causal_padded_rows(pad_kind):
    """Causal with a bias and a batch row whose first queries admit only
    padded keys ("head") or whose keys are all padded: the reference gives
    p = 1 on every key whose score rounds to -1e30, above the diagonal
    included, and the plain version, the card kernels' oracle, does too."""
    rng = np.random.RandomState(21)
    case = make_case(rng, 2, 128, 2, 32, "full", pad_kind)
    want_out, want_grads = jax_flash(case, 0.1, True, 32 ** -0.5)
    got_out, got_grads = port_flash(case, 0.1, True, 32 ** -0.5)
    np.testing.assert_allclose(got_out, want_out, atol=FWD_ATOL, rtol=0)
    for gname, g, w in zip("q k v bias".split(), got_grads, want_grads):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, rtol=0,
                                   err_msg=gname)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_flash_at_head_dim_80(dtype):
    """xlm's head dim (1280 / 16 = 80, no model before it used one that is
    not a power of two) at T = 256 with a full bias, tail padding and
    dropout 0.1.  fp32 within FWD_ATOL / GRAD_ATOL; bf16 (q, k, v and the
    bias in bf16 on both sides, the ``--bf16`` path) each tensor within
    1e-2 of its max, about one bf16 ulp there: the plain version rounds p,
    p_drop and dS to bf16 as the reference does, and the fp32 sums run in
    another order."""
    rng = np.random.RandomState(80)
    case = make_case(rng, 2, 256, 2, 80, "full", "tail")
    scale = 80 ** -0.5
    want_out, want_grads = jax_flash(case, 0.1, False, scale, dtype)
    got_out, got_grads = port_flash(case, 0.1, False, scale,
                                    dtype=getattr(torch, dtype))
    fp32 = dtype == "float32"
    np.testing.assert_allclose(
        got_out, want_out, rtol=0,
        atol=FWD_ATOL if fp32 else 1e-2 * np.abs(want_out).max())
    for gname, g, w in zip("q k v bias".split(), got_grads, want_grads):
        np.testing.assert_allclose(
            g, w, rtol=0, err_msg=gname,
            atol=GRAD_ATOL if fp32 else 1e-2 * np.abs(w).max())


# (T, bias item size) -> the reference's blocks; the LM at --max-seq-len
# 1024: a bf16 bias (or none) gives one key block (the joint backward),
# an fp32 bias two (the two-pass one)
CAUSAL_GEOMETRY = {(128, 4): (128, 128), (512, 2): (512, 512),
                   (1024, 2): (512, 1024), (1024, 4): (512, 512)}


@pytest.mark.parametrize("T,bias_itemsize", sorted(CAUSAL_GEOMETRY))
def test_causal_keep_bits_equal_jax(T, bias_itemsize):
    """The keep mask of the LM's causal call (one reference block at
    T = 128 and at the LM's T = 512 with a bf16 bias, two query blocks
    and one or two key blocks at T = 1024) equals the JAX package's
    counter-hash mask bit for bit: block (i, j) of (b, h) draws under
    seed[b] + (h·n_i + i)·n_j + j at block-local indices, causal or
    not."""
    import jax.numpy as jnp

    from unicore_tpu.ops.pallas import prng as jprng

    heads = 3
    seed = torch.tensor([7, -1640531527, 2 ** 31 - 1], dtype=torch.int32)
    geom = CAUSAL_GEOMETRY[T, bias_itemsize]
    assert fa.pick_blocks(T, T, bias_itemsize) == geom
    bq, bk = geom
    n_i, n_j = T // bq, T // bk
    mask = fa.keep_mask(seed, heads, T, T, geom, 0.9)
    for b in range(3):
        for h in range(heads):
            for i in range(n_i):
                for j in range(n_j):
                    # the kernels add in uint32, wrapping
                    block_seed = jnp.uint32(
                        (int(seed[b]) + (h * n_i + i) * n_j + j) % 2 ** 32)
                    want = np.asarray(jprng.keep_mask(block_seed, (bq, bk),
                                                      0.9))
                    np.testing.assert_array_equal(
                        mask[b, h, i * bq:(i + 1) * bq,
                             j * bk:(j + 1) * bk].numpy(), want)


# the reference's backward routes at T = 256 under pinned blocks: two key
# blocks take the two-pass dq and dk/dv and the dbias pass (rows 5-7), one
# key block over two query blocks the joint backward (row 4)
MULTIBLOCK_ROUTES = {"two_pass": (128, 128), "joint": (128, 256)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True],
                         ids=["full", "causal"])
@pytest.mark.parametrize("route", sorted(MULTIBLOCK_ROUTES, reverse=True))
def test_multiblock_mask_geometry_matches_jax(route, causal, dtype,
                                              monkeypatch):
    """T = 256 with both packages' block pick pinned to the route's
    blocks, a [1, H, T, T] bias, tail padding and dropout 0.1: the
    dropout seeds run over the block grid, (h·n_i + i)·n_j + j, the index
    is block-local, and under ``causal`` each block takes the
    reference's per-block triangle (``_causal_mask(i, j, ...)``) — the
    multi-block reference path an LM at T > 512 takes.  fp32 within
    FWD_ATOL / GRAD_ATOL; bf16 (operands and bias in bf16 on both sides)
    each tensor within 1e-2 of its max, one bf16 ulp there, as
    test_plain_bf16_rounds_where_the_reference_rounds holds it; dv, whose
    only rounding is p_drop's, equal in all but 1% of its elements — so
    the keep bits are the reference's."""
    import unicore_tpu.ops.pallas.flash_attention as jfa

    blocks = MULTIBLOCK_ROUTES[route]
    n_q, n_k = 256 // blocks[0], 256 // blocks[1]
    assert n_q == 2 and (n_k == 1) == (route == "joint")
    for mod, attr in ((jfa, "_pick_blocks"), (fa, "pick_blocks")):
        monkeypatch.setattr(mod, attr,
                            lambda tq, tk, bias_itemsize=0: blocks)
    rng = np.random.RandomState(11)
    case = make_case(rng, 2, 256, 2, 32, "full", "tail")
    want_out, want_grads = jax_flash(case, 0.1, causal, 32 ** -0.5, dtype)
    got_out, got_grads = port_flash(case, 0.1, causal, 32 ** -0.5,
                                    dtype=getattr(torch, dtype))
    fp32 = dtype == "float32"
    np.testing.assert_allclose(
        got_out, want_out, rtol=0,
        atol=FWD_ATOL if fp32 else 1e-2 * np.abs(want_out).max())
    for gname, g, w in zip("q k v bias".split(), got_grads, want_grads):
        np.testing.assert_allclose(
            g, w, rtol=0, err_msg=gname,
            atol=GRAD_ATOL if fp32 else 1e-2 * np.abs(w).max())
    if not fp32:
        assert (got_grads[2] != want_grads[2]).mean() < 0.01


def _rounding_case(name, monkeypatch):
    """``(case, D, causal, p)`` of a rounding test: a CASES entry at
    T = 128, or "multiblock": T = 256 with both packages' block picks
    pinned to (128, 128), two key blocks (the two-pass backward and the
    dbias pass)."""
    if name == "multiblock":
        import unicore_tpu.ops.pallas.flash_attention as jfa

        for mod, attr in ((jfa, "_pick_blocks"), (fa, "pick_blocks")):
            monkeypatch.setattr(mod, attr,
                                lambda tq, tk, bias_itemsize=0: (128, 128))
        return (make_case(np.random.RandomState(11), 2, 256, 2, 32, "full",
                          "tail"), 32, False, 0.1)
    H, D, bias_kind, pad_kind, causal, p = CASES[name]
    return (make_case(np.random.RandomState(3), 2, 128, H, D, bias_kind,
                      pad_kind), D, causal, p)


@pytest.mark.parametrize("name,dtype", _by_dtype(
    ["bias_full_pad_drop", "bias_heads1_pad_drop", "causal_drop",
     "causal_bias_pad_drop", "multiblock"], ("bfloat16", "float16")))
def test_plain_bf16_rounds_where_the_reference_rounds(name, dtype,
                                                      monkeypatch):
    """bf16 and fp16 operands: the plain backward rounds p_drop and dS to
    the operand type before its products, as the Pallas kernels cast them,
    so dv — whose only rounding is p_drop's — agrees bit for bit with the
    interpret-mode kernel in all but a few elements (before the rounding
    was added, 30-41% of dv's bf16 elements differed).  Every tensor within
    1e-2 (bf16) or 1e-3 (fp16) of its max, two ulps there: outputs in the
    operand type; the plain forward rounds p before p·V as the reference
    does (see test_plain_bf16_out_rounds_p_where_the_reference_does), and
    the remaining ulps come from fp32 summation order.  "multiblock": see
    :func:`_rounding_case`."""
    case, D, causal, p = _rounding_case(name, monkeypatch)
    scale = D ** -0.5
    rel = 1e-2 if dtype == "bfloat16" else 1e-3
    want_out, want_grads = jax_flash(case, p, causal, scale, dtype)
    got_out, got_grads = port_flash(case, p, causal, scale,
                                    dtype=getattr(torch, dtype))
    np.testing.assert_allclose(got_out, want_out,
                               atol=rel * np.abs(want_out).max(), rtol=0)
    for gname, g, w in zip("q k v bias".split(), got_grads, want_grads):
        np.testing.assert_allclose(g, w, atol=rel * np.abs(w).max(), rtol=0,
                                   err_msg=gname)
    assert (got_grads[2] != want_grads[2]).mean() < 0.01


@pytest.mark.parametrize("name,dtype", _by_dtype(
    ["bias_full_pad_drop", "bias_heads1_pad_drop", "causal_drop",
     "bias_row_drop", "multiblock"], ("bfloat16", "float16")))
def test_plain_bf16_out_rounds_p_where_the_reference_does(name, dtype,
                                                          monkeypatch):
    """bf16 and fp16 operands with dropout: the plain forward rounds the
    dropped p to the operand type before p·V, under the running max of the
    reference's key blocks, so its out equals the interpret-mode kernel's
    in all but under 0.1% (bf16) or 0.5% (fp16) of elements (with p·V in
    fp32, 35-42% differed in bf16 and 34-41% in fp16; rounding under the
    global max alone left 16% of the bf16 multi-block case).  fp16's
    finer ulps let more fp32 summation-order ties cross (0.07-0.18%
    measured).  "multiblock": see :func:`_rounding_case`."""
    case, D, causal, p = _rounding_case(name, monkeypatch)
    want_out, _ = jax_flash(case, p, causal, D ** -0.5, dtype)
    got_out, _ = port_flash(case, p, causal, D ** -0.5,
                            dtype=getattr(torch, dtype))
    assert (got_out != want_out).mean() < (1e-3 if dtype == "bfloat16"
                                           else 5e-3)


def test_params_mirror_the_header():
    """``_Params`` matches ``struct FlashParams`` of csrc/flash_params.cuh
    field for field — names, order and C types — as parsed from the
    header: a drift would corrupt every launch silently."""
    import ctypes
    import re

    from unicore_tpu_torch.ops import build

    text = (build.CSRC / "flash_params.cuh").read_text()
    body = re.search(r"struct FlashParams \{(.*?)\};", text, re.S).group(1)
    ctype = {"long long": ctypes.c_longlong, "int": ctypes.c_int,
             "float": ctypes.c_float, "uint32_t": ctypes.c_uint32}
    fields = []
    for decl in body.split(";"):
        decl = re.sub(r"//[^\n]*", "", decl).strip()
        if not decl:
            continue
        m = re.match(r"((?:const\s+)?[A-Za-z_][\w ]*?)\s*(\*?)\s*(\w+(?:\s*,"
                     r"\s*\w+)*)$", decl)
        base, star, names = m.groups()
        ct = ctypes.c_void_p if star else ctype[base.strip()]
        fields += [(n.strip(), ct) for n in names.split(",")]
    got = [(n, t) for n, t in fa._Params._fields_]
    assert got == fields
    assert ctypes.sizeof(fa._Params) == sum(ctypes.sizeof(t)
                                            for _, t in fields)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_forward_shared_memory_fits(d):
    """The bf16 forward's shared memory (``fwd_smem`` of
    csrc/flash_attention_fwd.cu) fits one block for every bias type, and
    up to D = 64 two blocks share an SM even with an fp32 bias; at BERT's
    shape (D 64, bf16 bias) four do."""
    for item in (0, 2, 4):
        assert fa.fwd_smem_bytes(d, item) <= fa.SMEM_BLOCK
        if d <= 64:
            assert 2 * (fa.fwd_smem_bytes(d, item) + 1024) <= fa.SMEM_SM
    assert fa.fwd_smem_bytes(64, 2) == 4 * 64 * 72 * 2 + 2 * 64 * 144 + 512
    assert 4 * (fa.fwd_smem_bytes(64, 2) + 1024) <= fa.SMEM_SM


@pytest.mark.parametrize("bsz", [1, 2, 3, 5, 7, 16, 17, 31])
def test_groups_cover_every_batch_row_once(bsz):
    """Every group pick the wrapper can make splits the batch into
    non-empty groups of at most ceil(B / G) rows that cover each row
    exactly once, in order; the rows fit the kernel's bound."""
    for tq, heads, d in ((512, 12, 64), (256, 2, 24), (2048, 12, 128),
                         (128, 1, 8)):
        groups = fa.pick_groups(bsz, tq, heads, d, True)
        assert 1 <= groups <= bsz
        rows = fa.group_rows(bsz, groups)
        assert [b for r in rows for b in r] == list(range(bsz))
        biggest = -(-bsz // groups)
        assert all(1 <= len(r) <= biggest for r in rows)
        assert biggest <= fa.BWD_MAX_ROWS
        assert fa.dq_smem_bytes(d, biggest) <= fa.SMEM_BLOCK
        assert fa.pick_groups(bsz, tq, heads, d, False) == bsz


def test_group_pick_fills_the_card_at_bert_shape():
    """BERT (B 16, H 12, T 512, D 64): at least two blocks per SM of the
    H100 and two blocks' shared memory within one SM; T = 2048 with a
    bias needs one group; no bias gradient, one row a group."""
    groups = fa.pick_groups(16, 512, 12, 64, True)
    assert (512 // fa.BWD_TILE) * 12 * groups >= 2 * fa.SMS
    rows = -(-16 // groups)
    assert 2 * (fa.dq_smem_bytes(64, rows) + 1024) <= fa.SMEM_SM
    assert fa.pick_groups(2, 2048, 12, 64, True) == 1
    assert fa.pick_groups(16, 512, 12, 64, False) == 16


@pytest.mark.parametrize("bsz,groups", [(16, 8), (5, 2), (7, 3), (4, 1)])
def test_group_partials_sum_to_the_batch_sum(bsz, groups):
    """dS of the plain backward summed per group (the kernel's partials,
    rows in order) and then over groups in the wrapper's order equals the
    plain dbias, ds.sum(0), within fp32 reassociation (1e-6 of its max)."""
    H, D, T = 2, 16, 128
    case = make_case(np.random.RandomState(bsz), bsz, T, H, D, "full",
                     "tail")
    q, k, v, w, bias, pad, seed = (None if x is None else torch.from_numpy(x)
                                   for x in case)
    scale = D ** -0.5
    geom = fa.geometry(T, T, bias)
    out, lse = fa.flash_fwd_plain(q, k, v, bias, pad, 0.1, seed, False,
                                  scale, geom)
    delta = (w * out).sum(dim=-1).transpose(1, 2)
    ds = []
    for b in range(bsz):  # dS of one row: the dbias of a batch of one
        sl = slice(b, b + 1)
        ds.append(fa.flash_bwd_plain(
            q[sl], k[sl], v[sl], bias, pad[sl], 0.1, seed[sl], False, scale,
            geom, lse[sl], delta[sl], w[sl], True)[3])
    parts = torch.stack([sum(ds[b] for b in rows)
                         for rows in fa.group_rows(bsz, groups)])
    want = fa.flash_bwd_plain(q, k, v, bias, pad, 0.1, seed, False, scale,
                              geom, lse, delta, w, True)[3]
    torch.testing.assert_close(torch.stack(ds).sum(0), want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))
    torch.testing.assert_close(fa.sum_partials(parts), want, rtol=0,
                               atol=1e-6 * float(want.abs().max()))


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
        "flash_attention.cu", "flash_params.cuh", "prng.cuh"]
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        assert [p.name for p in build.sources(name)] == [
            f"{name}.cu", "flash_params.cuh", "mma_bf16.cuh", "prng.cuh"]
    names = ("flash_attention", "flash_attention_fwd", "flash_attention_bwd",
             "paged_attention")
    before = {n: build.library_path(n) for n in names}
    header = csrc / "mma_bf16.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = {n: build.library_path(n) for n in names}
    assert [n for n in names if after[n] != before[n]] == [
        "flash_attention_fwd", "flash_attention_bwd"]
    header = csrc / "prng.cuh"
    header.write_text(header.read_text() + "// edited\n")
    assert build.library_path("flash_attention") != before["flash_attention"]
    assert build.library_path("paged_attention") == before["paged_attention"]


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


# name: (B, T or (Tq, Tk), H, D, bias kind, pad kind, causal, dropout,
# packed): the card cases of the kernels; ``packed`` lets the bf16 dq kernel put
# several batch rows in a group (the grid-fill rule of pick_groups off), as
# it does at BERT's shape, where small shapes would get one row a group
CARD_CASES = {
    "bias_full_pad_drop": (3, 256, 2, 32, "full", "tail", False, 0.1, False),
    "bias_heads1_pad_drop": (3, 256, 3, 16, "heads1", "all_row", False, 0.1,
                             True),
    "bias_row_pad": (3, 256, 2, 64, "row", "all_row", False, 0.0, False),
    "causal_drop": (3, 256, 2, 32, None, None, True, 0.1, False),
    "d128": (3, 256, 2, 128, "full", "tail", False, 0.1, True),
    "d24": (3, 256, 2, 24, "full", "tail", False, 0.1, True),
    # xlm's head dim: the D = 128 build with 48 zero columns
    "d80": (3, 256, 2, 80, "full", "tail", False, 0.1, True),
    "b5": (5, 256, 2, 64, "full", "all_row", False, 0.1, True),
    "t128": (3, 128, 2, 64, "full", "tail", False, 0.1, False),
    "causal_bias_all_row": (3, 256, 2, 32, "full", "all_row", True, 0.1,
                            True),
    "causal_head_pad": (3, 256, 2, 32, "full", "head", True, 0.0, True),
    "row_bias_packed": (5, 256, 2, 64, "row", "tail", False, 0.1, True),
    "causal_bias_pad_drop": (3, 256, 2, 32, "full", "tail", True, 0.1,
                             True),
    "causal_bias_heads1": (3, 256, 3, 16, "heads1", "tail", True, 0.1,
                           False),
    # cross-attention's Tq != Tk: more keys than queries, the key side
    # padded; fewer, one row's keys all padded and a row bias
    "cross_q128_k512": (3, (128, 512), 2, 64, "full", "tail", False, 0.1,
                        True),
    "cross_q256_k128": (3, (256, 128), 2, 32, "row", "all_row", False, 0.1,
                        False),
    # the LM's causal call past T = 512, in the reference's multi-block
    # geometry: at 1024 one key block in bf16 and fp16 (its joint
    # backward, rows 2 and 4) and two with the fp32 bias (rows 2, 5-7);
    # at 2048 two key blocks in every type, one batch row's keys all
    # padded
    "causal_t1024": (2, 1024, 2, 64, "full", "tail", True, 0.1, False),
    "causal_t2048": (2, 2048, 2, 64, "full", "all_row", True, 0.1, True),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CARD_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kernels_match_plain_on_card(cuda, name, dtype, monkeypatch):
    """The CUDA kernels vs the plain version on the same values: for bf16
    and fp16 the tensor-core forward and backward of that type (dk/dv; dq
    with dbias), for fp32 the fp32 forward and backward (dk/dv, dq,
    dbias).  fp32 within 1e-4 (out) and 1e-3 of each grad's max; bf16 and
    fp16 against the plain version on the same tensors, which rounds p,
    p_drop and dS as the kernels do, within 2e-2 (bf16) or 5e-3 (fp16, 3
    more mantissa bits) of each tensor's max."""
    B, T, H, D, bias_kind, pad_kind, causal, p, packed = CARD_CASES[name]
    if packed:
        monkeypatch.setattr(fa, "SMS", 1)
    case = make_case(np.random.RandomState(5), B, T, H, D, bias_kind,
                     pad_kind)
    dt = getattr(torch, dtype)
    before = dict(fa.launches)
    got_out, got_grads = port_flash(case, p, causal, D ** -0.5, cuda, dt)
    torch.cuda.synchronize()
    bf16, fp16 = dtype == "bfloat16", dtype == "float16"
    fp32 = not (bf16 or fp16)
    want = {"flash_fwd": int(fp32), "flash_fwd_bf16": int(bf16),
            "flash_bwd_dkdv": int(bf16), "flash_bwd_dq": int(bf16),
            "flash_fwd_fp16": int(fp16), "flash_bwd_dkdv_fp16": int(fp16),
            "flash_bwd_dq_fp16": int(fp16), "flash_dkdv": int(fp32),
            "flash_dq": int(fp32),
            "flash_dbias": int(fp32 and bias_kind is not None)}
    assert {n: fa.launches[n] - before[n] for n in fa.launches} == want
    want_out, want_grads = port_flash(case, p, causal, D ** -0.5, dtype=dt)
    rel = 1e-3 if fp32 else 2e-2 if bf16 else 5e-3
    tol_out = 1e-4 if fp32 else rel * np.abs(want_out).max()
    np.testing.assert_allclose(got_out, want_out, atol=tol_out, rtol=0)
    for gname, g, w in zip("q k v bias".split(), got_grads, want_grads):
        np.testing.assert_allclose(g, w, atol=rel * np.abs(w).max(), rtol=0,
                                   err_msg=gname)


@pytest.mark.gpu
@pytest.mark.parametrize("packed,dtype",
                         _by_dtype([False, True], ("bfloat16", "float16")))
def test_bf16_backward_is_bit_identical_on_card(cuda, packed, dtype,
                                                monkeypatch):
    """Two bf16 (or fp16) backward calls on the same inputs give the same
    bits: no atomics, the dbias partials summed in a fixed order."""
    if packed:
        monkeypatch.setattr(fa, "SMS", 1)
    B, T, H, D = 5, 256, 2, 64
    q, k, v, w, bias, pad, seed = make_case(np.random.RandomState(9), B, T,
                                            H, D, "full", "tail")
    dev = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    dt = getattr(torch, dtype)
    q, k, v, w, bias = (dev(x).to(dt) for x in (q, k, v, w, bias))
    pad, seed = dev(pad), dev(seed)
    geom = fa.geometry(T, T, bias)
    args = (pad, 0.1, seed, False, D ** -0.5, geom)
    out, lse = fa.flash_fwd_cuda(q, k, v, bias, *args)
    delta = (w.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    first = fa.flash_bwd_cuda(q, k, v, bias, *args, lse, delta, w, True)
    second = fa.flash_bwd_cuda(q, k, v, bias, *args, lse, delta, w, True)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype", _by_dtype(
    ["bias_full_pad_drop", "causal_drop", "d128", "b5"],
    ("bfloat16", "float16")))
def test_bf16_forward_is_bit_identical_on_card(cuda, name, dtype):
    """Two bf16 (or fp16) forward calls on the same inputs give the same
    bits, and the lse within 2e-4 of the plain version's."""
    B, T, H, D, bias_kind, pad_kind, causal, p, _ = CARD_CASES[name]
    q, k, v, _, bias, pad, seed = make_case(np.random.RandomState(13), B, T,
                                            H, D, bias_kind, pad_kind)
    def dev(x):
        return None if x is None else torch.from_numpy(x).to(cuda)

    dt = getattr(torch, dtype)
    q, k, v = (dev(x).to(dt) for x in (q, k, v))
    bias = None if bias is None else dev(bias).to(dt)
    pad, seed = dev(pad), dev(seed)
    geom = fa.geometry(T, T, bias)
    args = (pad, p, seed, causal, D ** -0.5, geom)
    first = fa.flash_fwd_cuda(q, k, v, bias, *args)
    second = fa.flash_fwd_cuda(q, k, v, bias, *args)
    torch.cuda.synchronize()
    for what, a, b in zip(("out", "lse"), first, second):
        assert torch.equal(a, b), what
    _, lse = fa.flash_fwd_plain(q.cpu(), k.cpu(), v.cpu(),
                                None if bias is None else bias.cpu(),
                                None if pad is None else pad.cpu(), p,
                                seed.cpu(), causal, D ** -0.5, geom)
    torch.testing.assert_close(first[1].cpu(), lse, rtol=0, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [256, 1024, 2048])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_causal_dbias_is_zero_above_the_diagonal_on_card(cuda, dtype,
                                                         packed, T,
                                                         monkeypatch):
    """Causal with a bias and tail padding: the backward's dbias is
    exactly 0 above the diagonal, where the reference's is, in the key
    tiles the dq kernel skips too: each group's partial of a skipped tile
    is written as 0, not left unwritten.  T = 1024 and 2048 are the
    reference's multi-block geometries."""
    if packed:
        monkeypatch.setattr(fa, "SMS", 1)
    B, H, D = 5, 2, 32
    q, k, v, w, bias, pad, seed = make_case(np.random.RandomState(17), B, T,
                                            H, D, "full", "tail")
    dt = getattr(torch, dtype)
    dev = lambda x: torch.from_numpy(x).to(cuda)  # noqa: E731
    q, k, v, w, bias = (dev(x).to(dt) for x in (q, k, v, w, bias))
    pad, seed = dev(pad), dev(seed)
    geom = fa.geometry(T, T, bias)
    args = (pad, 0.1, seed, True, D ** -0.5, geom)
    out, lse = fa.flash_fwd_cuda(q, k, v, bias, *args)
    delta = (w.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    for _ in range(2):  # the second call reuses the first's freed blocks
        dbias = fa.flash_bwd_cuda(q, k, v, bias, *args, lse, delta, w,
                                  True)[3]
    torch.cuda.synchronize()
    above = torch.ones(T, T, dtype=torch.bool, device=cuda).triu(1)
    assert torch.isfinite(dbias).all()
    assert int((dbias[:, above] != 0).sum()) == 0
    assert float(dbias[:, ~above].abs().max()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["d80", "causal_t1024", "causal_t2048"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_keep_bits_are_exact_on_card(cuda, dtype, name):
    """The forward kernel's keep bits at a CARD_CASES entry (xlm's head
    dim; the causal multi-block geometries), read back exactly
    (``kernel_keep_bits``: q = k = 0, a zero bias, v spelling four keys'
    bits in each output element) and equal to the plain version's mask
    on the admitted keys, 0 on the padded and causally masked ones."""
    B, T, H, D, _, pad_kind, causal, p, _ = CARD_CASES[name]
    _, _, _, _, bias, pad, seed = make_case(np.random.RandomState(5), B, T,
                                            H, D, "full", pad_kind)
    dt = getattr(torch, dtype)
    bias = torch.zeros(bias.shape, dtype=dt, device=cuda)
    pad, seed = torch.from_numpy(pad).to(cuda), torch.from_numpy(seed)
    bits, admitted = fa.kernel_keep_bits((B, T, H, D), T, dt, bias, pad,
                                         seed.to(cuda), p, causal)
    want = fa.keep_mask(seed, H, T, T, fa.geometry(T, T, bias), 1.0 - p)
    assert torch.equal(bits.cpu(), want & admitted.cpu())


@pytest.mark.gpu
def test_ineligible_shapes_raise_on_card(cuda):
    q = torch.zeros(1, 100, 2, 16, device=cuda)
    with pytest.raises(NotImplementedError, match="eligible shapes only"):
        fa.flash_attention(q, q, q)
