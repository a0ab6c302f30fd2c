"""Fused softmax + dropout of the PyTorch port (unicore_tpu_torch/ops/
softmax_dropout.py, csrc/softmax_dropout.cu) against the JAX package's
Pallas kernel (``unicore_tpu.ops.pallas.softmax_dropout.softmax_dropout``,
run in interpret mode on the CPU, called directly as tests/test_pallas.py
does), on the seed the JAX function draws from its key.

With dropout on, the zeros of out (the keep pattern) must be equal
exactly.  Tolerances: fp32 — out 1e-6, dx and dbias 1e-5 (both sides
exact fp32, exp and summation order differ); bf16 — 1e-2 of each
tensor's max (a bf16 ulp at 1 is 7.8e-3: both sides round the same fp32
value, which may sit on either side of a rounding boundary); fp16 — 2e-3
of each tensor's max (its ulp at 1 is 9.8e-4, the same argument).  Where a card
is present, the CUDA kernels vs the plain version, and the backward's keep
bits exactly (``check_backward``: a per-element bound that any wrong keep
bit exceeds wherever g is not 0).

The JAX side is imported inside the tests, so that the card-only cases
can run where JAX is not installed."""

import numpy as np
import pytest
import torch

from unicore_tpu_torch.ops import softmax_dropout as sd

# name: (x shape, mask shape, bias shape)
CASES = {
    "bert_4d": ((2, 3, 16, 128), (2, 1, 1, 128), (1, 3, 16, 128)),
    "bert_bias_only": ((2, 3, 16, 256), None, (1, 3, 16, 256)),
    "tri_mask_g11k_bias_11hqk": ((2, 3, 4, 16, 128), (2, 3, 1, 1, 128),
                                 (1, 1, 4, 16, 128)),
    "tri_mask_gh1k_bias_1ghqk": ((2, 3, 4, 16, 128), (2, 3, 4, 1, 128),
                                 (1, 3, 4, 16, 128)),
    "rows_in_two_blocks": ((1, 32, 8192), (1, 1, 8192), None),
}
DTYPES = {"float32": (np.float32, 1e-6, 1e-5), "bfloat16": (None, 1e-2, 1e-2),
          "float16": (None, 2e-3, 2e-3)}


def make_case(name, dtype):
    xs, ms, bs = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    x = rng.randn(*xs).astype(np.float32)
    mask = None if ms is None else (
        (rng.rand(*ms) > 0.3).astype(np.float32) - 1.0) * 1e4
    bias = None if bs is None else rng.randn(*bs).astype(np.float32)
    w = rng.randn(*xs).astype(np.float32)
    if dtype != "float32":  # both sides see the same 2-byte values
        x, bias = (None if a is None else
                   torch.from_numpy(a).to(getattr(torch, dtype)).float()
                   .numpy() for a in (x, bias))
    return x, mask, bias, w


def jax_run(case, dtype, p, key_seed):
    """out, dx, dbias (fp32 numpy) and the seed the JAX function drew."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.ops.pallas import softmax_dropout as jsd

    x, mask, bias, w = case
    jdt = getattr(jnp, dtype)
    key = jax.random.PRNGKey(key_seed)
    xj = jnp.asarray(x, jdt)
    mj = None if mask is None else jnp.asarray(mask)
    bj = None if bias is None else jnp.asarray(bias, jdt)

    def f(xx, bb):
        out = jsd.softmax_dropout(xx, p, rng=key, is_training=True, mask=mj,
                                  bias=bb)
        return jnp.sum(out.astype(jnp.float32) * w), out

    argnums = (0,) if bias is None else (0, 1)
    (_, out), grads = jax.value_and_grad(f, argnums=argnums, has_aux=True)(
        xj, bj)
    seed = int(jax.random.randint(key, (1,), 0, 2 ** 31 - 1,
                                  dtype=jnp.int32)[0])
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return (f32(out), f32(grads[0]),
            None if bias is None else f32(grads[1]), seed)


def port_run(case, dtype, p, seed, device="cpu", check=False):
    """out, dx, dbias (fp32 numpy) of the port's autograd path; with
    ``check``, also the autograd backward's dx and dbias held by
    :func:`~unicore_tpu_torch.ops.softmax_dropout.check_backward` against
    the plain backward of the same g, saved softmax and seed."""
    x, mask, bias, w = case
    dt = getattr(torch, dtype)
    xt = torch.tensor(x, dtype=dt, device=device, requires_grad=True)
    mt = None if mask is None else torch.tensor(mask, device=device)
    bt = None if bias is None else torch.tensor(bias, dtype=dt, device=device,
                                                requires_grad=True)
    out = sd.softmax_dropout(xt, p, mask=mt, bias=bt, seed=seed)
    if check:  # read before the backward frees them
        sm, seed_t = out.grad_fn.saved_tensors
    wt = torch.from_numpy(w).to(device)
    (out.float() * wt).sum().backward()
    f32 = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    got = f32(out), f32(xt.grad), None if bt is None else f32(bt.grad)
    if not check:
        return got
    return got, sd.check_backward(
        xt.grad, wt.to(dt), sm, p, seed_t, sd.pick_q_blk_for(xt, mt, bt),
        dbias=None if bt is None else bt.grad)


@pytest.mark.parametrize("p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_kernel(name, dtype, p):
    case = make_case(name, dtype)
    want_out, want_dx, want_db, seed = jax_run(case, dtype, p, 3)
    got_out, got_dx, got_db = port_run(case, dtype, p, seed)
    if p > 0:
        np.testing.assert_array_equal(got_out == 0, want_out == 0)
        assert 0.05 < (want_out == 0).mean() < 0.5
    _, tol_out, tol_grad = DTYPES[dtype]
    scale = (lambda a: 1.0) if dtype == "float32" else (
        lambda a: float(np.abs(a).max()))
    np.testing.assert_allclose(got_out, want_out, rtol=0,
                               atol=tol_out * scale(want_out))
    np.testing.assert_allclose(got_dx, want_dx, rtol=0,
                               atol=tol_grad * scale(want_dx))
    if want_db is not None:
        np.testing.assert_allclose(got_db, want_db, rtol=0,
                                   atol=tol_grad * scale(want_db))


def test_pick_q_blk_matches_jax():
    import jax.numpy as jnp

    from unicore_tpu.ops.pallas import softmax_dropout as jsd

    for q in (1, 8, 16, 24, 100, 128, 256, 512, 2048):
        for k in (128, 256, 1024, 4096, 8192):
            for jdt, tdt in ((jnp.float32, torch.float32),
                             (jnp.bfloat16, torch.bfloat16),
                             (jnp.float16, torch.float16)):
                for m, b in ((None, None), (1, None), (None, 1), (1, 1)):
                    xj = jnp.zeros((1, q, k), jdt)
                    xt = torch.zeros((1, q, k), dtype=tdt)
                    want = jsd._pick_q_blk_for(xj, m, b)
                    assert sd.pick_q_blk_for(xt, m, b) == want, (q, k, jdt)


def test_eligibility_copies_the_reference():
    import jax.numpy as jnp

    from unicore_tpu.ops.softmax_dropout import _pallas_eligible

    shapes = [((2, 16, 128), None, None), ((2, 16, 100), None, None),
              ((2, 16, 8320), None, None), ((2, 16, 256), (2, 1, 1), None),
              ((2, 16, 256), None, (1, 16, 256)), ((128,), None, None)]
    for xs, ms, bs in shapes:
        ops = [None if s is None else jnp.zeros(s) for s in (ms, bs)]
        tops = [None if s is None else torch.zeros(s) for s in (ms, bs)]
        assert sd.eligible(torch.zeros(xs), *tops) == _pallas_eligible(
            jnp.zeros(xs), *ops), xs


ROUTE_OPS = {  # (mask shape, bias shape) for x [..., 16, k]
    "none": lambda lead, k: (None, None),
    "mask_bias": lambda lead, k: ((*lead[:1], *(1,) * (len(lead) - 1), 1, k),
                                  ((1, *lead[1:]) if lead else ()) + (16, k)),
    "mask_over_k": lambda lead, k: ((*lead, 1, 1), None),
    "bias_over_k": lambda lead, k: (None, (1, 16, 1)),
}


@pytest.mark.parametrize("ndim", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("k", [128, 200, 256, 8192, 8320])
def test_route_is_the_reference_dispatch(k, ndim):
    """``route`` sends a shape to the kernels exactly where the JAX
    package's ``_pallas_eligible`` takes its Pallas kernel, for k on and
    off the grid, operands broadcast over k or not, and 2-D to 6-D x."""
    import jax.numpy as jnp

    from unicore_tpu.ops.softmax_dropout import _pallas_eligible

    lead = (2, 3, 2, 2)[:ndim - 2]
    for name, ops in ROUTE_OPS.items():
        shapes = ops(lead, k)
        x = (*lead, 16, k)
        want = _pallas_eligible(jnp.zeros(x), *(
            None if s is None else jnp.zeros(s) for s in shapes))
        got = sd.route(torch.zeros(x), *(
            None if s is None else torch.zeros(s) for s in shapes))
        assert got == ("kernel" if want else "plain"), (name, x, shapes)


@pytest.mark.parametrize("x_shape,mask_shape,bias_shape", [
    ((2, 2, 3, 2, 16, 128), (2, 1, 3, 1, 1, 128), (1, 2, 1, 2, 16, 128)),
    ((2, 2, 3, 2, 16, 128), (2, 2, 1, 2, 1, 128), None),
    ((2, 1, 3, 2, 16, 128), (1, 1, 16, 128), (2, 1, 3, 1, 16, 128)),
])
def test_fold_lead_keeps_rows_and_dropout_bits(x_shape, mask_shape,
                                               bias_shape):
    """The kernels take at most five dims; a 6-D x folds its lead dims
    row-major (a size-1 dim first; operands broadcast over one dim of a
    folded pair but not the other are expanded), so the plain forward of
    the folded operands is the plain forward of the originals, dropout
    bits included, bit for bit."""
    rng = np.random.RandomState(len(mask_shape))
    x, mask, bias = (None if s is None else torch.from_numpy(
        rng.randn(*s).astype(np.float32))
        for s in (x_shape, mask_shape, bias_shape))
    seed = torch.tensor([-31], dtype=torch.int32)
    q_blk = sd.pick_q_blk_for(x, mask, bias)
    folded = sd.fold_lead(x, mask, bias)
    assert folded[0].dim() <= sd.MAX_KERNEL_DIMS
    want = sd.softmax_dropout_fwd_plain(x, mask, bias, 0.1, seed, q_blk, True)
    got = sd.softmax_dropout_fwd_plain(*folded, 0.1, seed, q_blk, True)
    assert (got[0] == 0).any()
    for g, w in zip(got, want):
        assert torch.equal(g.reshape(w.shape), w)


def test_keep_mask_follows_the_program_grid():
    """Rows of q_blk share one program; the program id runs over (lead
    dims..., row block), and the index is block-local."""
    from unicore_tpu_torch.ops import prng

    seed = torch.tensor([-5], dtype=torch.int32)
    keep = sd.keep_mask(seed, (2, 3, 32, 128), 16, 0.9)
    for lead in range(6):
        for blk in range(2):
            want = prng.keep_mask(-5 + lead * 2 + blk, (16, 128), 0.9)
            got = keep.reshape(6, 2, 16, 128)[lead, blk]
            assert torch.equal(got, want)


def test_generator_draws_the_seed_and_eval_is_deterministic():
    x = torch.randn(2, 8, 128)
    run = lambda s: sd.softmax_dropout(  # noqa: E731
        x, 0.3, generator=torch.Generator().manual_seed(s))
    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    off = sd.softmax_dropout(x, 0.3, is_training=False)
    torch.testing.assert_close(off, torch.softmax(x, -1), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="generator"):
        sd.softmax_dropout(x, 0.3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_forward_operands_are_16_byte_aligned(dtype):
    """The forward's operands as its 16-byte runs read them: an aligned
    tensor, a broadcast operand and a view of every other row pass as
    they are; a view offset by one element (its address off 16 bytes) is
    copied, with the same values."""
    x = torch.randn(2, 4, 128).to(dtype)
    mask = torch.zeros(2, 1, 128)
    bias = torch.randn(1, 4, 128).to(dtype)
    got_x, sx, ops = sd.fwd_operands(x, mask, bias)
    assert got_x is x and sx == [0, 0, 512, 128]
    assert [(n, op is src, st) for (n, op, st), src in zip(ops, (mask, bias))
            ] == [("mask", True, [0, 0, 128, 0]),
                  ("bias", True, [0, 0, 0, 128])]
    rows = torch.randn(2, 8, 128).to(dtype)[:, ::2]
    got_x, sx, _ = sd.fwd_operands(rows, None, None)
    assert got_x is rows and sx == [0, 0, 1024, 256]
    off = torch.randn(2 * 4 * 128 + 1).to(dtype)[1:].view(2, 4, 128)
    off_mask = torch.zeros(2 * 128 + 1)[1:].view(2, 1, 128)
    got_x, sx, ops = sd.fwd_operands(off, off_mask, None)
    for got, src in ((got_x, off), (ops[0][1], off_mask)):
        assert got.data_ptr() != src.data_ptr() and got.data_ptr() % 16 == 0
        assert torch.equal(got, src)
    assert sx == [0, 0, 512, 128]


@pytest.mark.parametrize("x_dtype,op_dtype", [
    (torch.float16, torch.bfloat16), (torch.bfloat16, torch.float16),
    (torch.float32, torch.float16), (torch.float16, torch.float64)])
def test_forward_operands_widen_other_types_to_fp32(x_dtype, op_dtype):
    """mask and bias reach the forward in fp32 or in x's type (the
    kernels' instantiations); any other type is widened to fp32, with the
    same values, and an operand of x's type passes as it is."""
    x = torch.randn(2, 4, 128).to(x_dtype)
    mask = torch.randn(2, 1, 128).to(op_dtype)
    bias = torch.randn(1, 4, 128).to(x_dtype)
    _, _, ops = sd.fwd_operands(x, mask, bias)
    (_, got_mask, _), (_, got_bias, _) = ops
    assert got_mask.dtype == torch.float32
    assert torch.equal(got_mask, mask.float())
    assert got_bias is bias


def test_bias_of_x_shape_gets_dx_itself():
    """Uni-Mol's per-batch bias has x's shape: its gradient is dx, a view
    of the same storage in dx's type (the reference's sum over no axes),
    with no reduction and no copy; a broadcast bias is still summed in
    fp32 and rounded once."""
    dx = torch.randn(2, 3, 16, 128).half()
    got = sd._reduce_to(dx, (2, 3, 16, 128), torch.float16)
    assert got.data_ptr() == dx.data_ptr() and torch.equal(got, dx)
    summed = sd._reduce_to(dx, (1, 3, 16, 128), torch.float16)
    assert torch.equal(summed, dx.float().sum(0, keepdim=True).half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_backward_operands_are_16_byte_aligned(dtype):
    """g and sm as the backward's 16-byte runs read them: aligned
    contiguous tensors pass as they are; an fp32 g for a bf16 softmax is
    cast, a transposed g made contiguous; a contiguous view at a
    2-element offset (its address off 16 bytes) is copied, with the same
    values."""
    g = torch.randn(2, 4, 128).to(dtype)
    sm = torch.rand(2, 4, 128).to(dtype)
    got_g, got_sm = sd.bwd_operands(g, sm)
    assert got_g is g and got_sm is sm
    got_g, _ = sd.bwd_operands(g.float(), sm)
    assert got_g.dtype == dtype and torch.equal(got_g, g.float().to(dtype))
    gt = torch.randn(2, 128, 4).to(dtype).transpose(1, 2)
    got_g, _ = sd.bwd_operands(gt, sm)
    assert got_g.is_contiguous() and got_g.data_ptr() % 16 == 0
    assert torch.equal(got_g, gt)
    off = torch.randn(2 * 4 * 128 + 2).to(dtype)[2:].view(2, 4, 128)
    assert off.is_contiguous() and off.data_ptr() % 16 != 0
    for got in sd.bwd_operands(off, off):
        assert got.data_ptr() != off.data_ptr() and got.data_ptr() % 16 == 0
        assert torch.equal(got, off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_check_sees_one_flipped_keep_bit(name, dtype):
    """``check_backward`` passes the plain dx against itself (dx and
    dbias), and fails once a single keep bit of the plain version's mask
    is flipped on an element whose softmax is below 1e-4 of its row's max
    and whose |g| is at least 0.1 — where a bound relative to the
    tensor's max sees nothing — and whose y·|g| is at least 4 steps of
    the type's subnormal range (in fp16, 2^-24: a flip below that rounds
    to the same dx).  x is scaled by 4 so that every row's softmax spans
    such decades."""
    x, mask, bias, w = make_case(name, str(dtype).replace("torch.", ""))
    xt = (4 * torch.from_numpy(x)).to(dtype)
    mt = None if mask is None else torch.from_numpy(mask)
    bt = None if bias is None else torch.from_numpy(bias).to(dtype)
    mt, bt = sd.canon(xt, mt, bt)
    seed = torch.tensor([2024], dtype=torch.int32)
    q_blk = sd.pick_q_blk_for(xt, mt, bt)
    _, sm = sd.softmax_dropout_fwd_plain(xt, mt, bt, 0.1, seed, q_blk, True)
    g = torch.from_numpy(w).to(dtype)
    dx = sd.softmax_dropout_bwd_plain(g, sm, 0.1, seed, q_blk)
    dbias = None if bt is None else sd._reduce_to(dx, bt.shape, bt.dtype)
    errs = sd.check_backward(dx, g, sm, 0.1, seed, q_blk, dbias=dbias)
    assert set(errs.values()) == {0.0}
    # a right backward whose dot sums in another order passes: the exact
    # dx (float64) moved by up to the reordering's fp32 error, K·2^-23 of
    # the row's Σ|g'·y| times |y|, then rounded to nearest as a kernel
    # rounds, so some elements land one ulp off the plain dx
    keep = sd.keep_mask(seed, tuple(sm.shape), q_blk, 0.9)
    y64 = sm.double()
    gp64 = torch.where(keep, g.double() * (1.0 / 0.9), 0.0)
    gy = gp64 * y64
    shift = (y64.abs() * y64.shape[-1] * 2.0 ** -23
             * gy.abs().sum(dim=-1, keepdim=True)
             * (2 * torch.rand(y64.shape, generator=torch.Generator()
                               .manual_seed(5), dtype=torch.float64) - 1))
    right = (y64 * (gp64 - gy.sum(dim=-1, keepdim=True))
             + shift).float().to(dtype)
    assert not torch.equal(right, dx)
    sd.check_backward(right, g, sm, 0.1, seed, q_blk, dbias=None if bt is None
                      else sd._reduce_to(right, bt.shape, bt.dtype))

    y = sm.float()
    step = torch.finfo(dtype).tiny * torch.finfo(dtype).eps
    small = ((y > 0) & (y < 1e-4 * y.amax(dim=-1, keepdim=True))
             & (g.float().abs() >= 0.1) & (y * g.float().abs() >= 4 * step))
    i = int(torch.nonzero(small.reshape(-1))[0])
    keep.reshape(-1)[i] ^= True
    gp = torch.where(keep, g.float() * (1.0 / 0.9), 0.0)
    flipped = (y * (gp - (gp * y).sum(dim=-1, keepdim=True))).to(dtype)
    assert torch.count_nonzero(flipped != dx) >= 1
    with pytest.raises(AssertionError, match="wrong keep bit"):
        sd.check_backward(flipped, g, sm, 0.1, seed, q_blk)


def attention_case(rng, bsz=2, t=128, d=32, heads=4):
    query = rng.randn(bsz, t, d).astype(np.float32)
    pad = np.zeros((bsz, t), np.int32)
    pad[1, -30:] = 1
    # a per-batch [B*H, T, T] bias: flash does not take it
    bias = rng.randn(bsz * heads, t, t).astype(np.float32)
    return query, pad, bias


def test_self_attention_materialized_path_matches_jax():
    """``SelfMultiheadAttention`` at a shape flash does not take goes the
    JAX module's materialized way — pad added to the scores, then
    softmax_dropout with the bias — and equals it at dropout 0: out and
    the query and bias grads within 1e-5 of each tensor's max."""
    import jax
    import jax.numpy as jnp

    from unicore_tpu.modules.multihead_attention import \
        SelfMultiheadAttention as FlaxAttention
    from unicore_tpu_torch.examples.lm.convert import _qkv_weight
    from unicore_tpu_torch.modules import SelfMultiheadAttention

    rng = np.random.RandomState(9)
    query, pad, bias = attention_case(rng)
    d, heads = query.shape[-1], 4
    fmod = FlaxAttention(d, heads, dropout=0.0)
    params = fmod.init(jax.random.PRNGKey(1), jnp.asarray(query),
                       jnp.asarray(pad), jnp.asarray(bias))["params"]
    w = rng.randn(*query.shape).astype(np.float32)

    def loss(qq, bb):
        out = fmod.apply({"params": params}, qq, jnp.asarray(pad), bb)
        return jnp.sum(out * w), out

    (_, want), (want_dq, want_db) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(query),
                                            jnp.asarray(bias))
    port = SelfMultiheadAttention(d, heads, dropout=0.0)
    port.load_state_dict({
        "in_proj.weight": torch.from_numpy(np.array(_qkv_weight(
            np.asarray(params["in_proj"]["kernel"])))),
        "in_proj.bias": torch.from_numpy(
            np.array(params["in_proj"]["bias"]).reshape(-1)),
        "out_proj.weight": torch.from_numpy(
            np.asarray(params["out_proj"]["kernel"]).T.copy()),
        "out_proj.bias": torch.from_numpy(
            np.array(params["out_proj"]["bias"])),
    })
    qt = torch.tensor(query, requires_grad=True)
    bt = torch.tensor(bias, requires_grad=True)
    got = port(qt, torch.from_numpy(pad), bt)
    (got * torch.from_numpy(w)).sum().backward()
    for g, x in ((got.detach(), want), (qt.grad, want_dq),
                 (bt.grad, want_db)):
        x = np.asarray(x)
        np.testing.assert_allclose(g.numpy(), x, rtol=0,
                                   atol=1e-5 * np.abs(x).max())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernels_match_plain_on_card(cuda, name, dtype):
    """The CUDA forward and backward vs the plain version on the same
    values at dropout 0.1: equal keep patterns; fp32 within 1e-5, bf16
    within 2e-2 of each tensor's max; and the backward's dx and dbias
    held exactly on its keep bits (``check_backward``, against the plain
    backward of the saved softmax)."""
    case = make_case(name, dtype)
    before = dict(sd.launches)
    got, errs = port_run(case, dtype, 0.1, 12345, cuda, check=True)
    torch.cuda.synchronize()
    assert sd.launches["softmax_dropout_fwd"] == before[
        "softmax_dropout_fwd"] + 1
    assert sd.launches["softmax_dropout_bwd"] == before[
        "softmax_dropout_bwd"] + 1
    assert set(errs) == ({"dx", "dbias"} if case[2] is not None
                         else {"dx"})
    want = port_run(case, dtype, 0.1, 12345)
    np.testing.assert_array_equal(got[0] == 0, want[0] == 0)
    for g, w in zip(got, want):
        if w is None:
            continue
        tol = 1e-5 if dtype == "float32" else 2e-2 * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def backward_case(shape, dtype, seed):
    """g and a softmax of 210 rows: scores of 3·N(0, 1) with about a
    fifth of the keys masked, so rows span many decades and hold zeros."""
    gen = torch.Generator().manual_seed(seed)
    z = 3 * torch.randn(shape, generator=gen)
    z = z.masked_fill(torch.rand(shape, generator=gen) < 0.2, -1e9)
    sm = torch.softmax(z, dim=-1).to(dtype)
    g = torch.randn(shape, generator=gen).to(dtype)
    return g, sm


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k", [128, 384, 1024, 1152, 2048, 8192])
def test_backward_keep_bits_exact_on_card(cuda, k, dtype):
    """The backward kernel at every split a K on the grid reaches — 4, 8,
    16 or 32 lanes a row (K = 128, 384 with a lane's last run idle, 1024)
    and a block (1152 with idle threads, 2048, 8192) — at 210 rows, not
    a multiple of any warp split's rows a block, dropout 0.1 and the
    reference's q_blk: one launch, dx held exactly on its keep bits
    (``check_backward``)."""
    shape = (2, 3, 5, 7, k)
    g, sm = (t.to(cuda) for t in backward_case(shape, getattr(torch, dtype),
                                                k))
    seed = torch.tensor([777], dtype=torch.int32, device=cuda)
    q_blk = sd.pick_q_blk_for(sm, None, None)
    before = sd.launches["softmax_dropout_bwd"]
    dx = sd.softmax_dropout_bwd_cuda(g, sm, 0.1, seed, q_blk)
    torch.cuda.synchronize()
    assert sd.launches["softmax_dropout_bwd"] == before + 1
    assert dx.shape == sm.shape and dx.dtype == sm.dtype
    sd.check_backward(dx, g, sm, 0.1, seed, q_blk)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_backward_copies_a_misaligned_g_on_card(cuda, dtype):
    """A g that is a contiguous view at a 2-element offset (its address
    off 16 bytes) is copied by ``bwd_operands`` and gives the same dx,
    bit for bit, as an aligned g of the same values."""
    shape = (2, 3, 5, 7, 256)
    g, sm = (t.to(cuda) for t in backward_case(shape, getattr(torch, dtype),
                                                1))
    g_off = torch.empty(g.numel() + 2, dtype=g.dtype, device=cuda)[2:].view(
        shape)
    g_off.copy_(g)
    assert g_off.data_ptr() % 16 != 0
    assert sd.bwd_operands(g_off, sm)[0].data_ptr() != g_off.data_ptr()
    seed = torch.tensor([31], dtype=torch.int32, device=cuda)
    dx_off = sd.softmax_dropout_bwd_cuda(g_off, sm, 0.1, seed, 1)
    dx = sd.softmax_dropout_bwd_cuda(g, sm, 0.1, seed, 1)
    torch.cuda.synchronize()
    assert torch.equal(dx_off, dx)
    sd.check_backward(dx_off, g_off, sm, 0.1, seed, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["g_off_16", "dx_off_16", "rows_2_31"])
def test_backward_entry_rejects_what_it_does_not_take(cuda, fault):
    """The backward's C entry refuses, before any launch, an operand off
    16 bytes and rows >= 2^31: the wrapper raises KernelError and counts
    no launch."""
    from unicore_tpu_torch.ops import build

    sm = torch.full((4, 128), 1 / 128, device=cuda)
    g = torch.ones_like(sm)
    dx = torch.empty_like(sm)
    seed = torch.tensor([1], dtype=torch.int32, device=cuda)
    prm = sd._params(4, 128, 4, 0.1, seed, 1)
    prm.g, prm.sm, prm.dx = g.data_ptr(), sm.data_ptr(), dx.data_ptr()
    if fault == "g_off_16":
        prm.g += 4
    elif fault == "dx_off_16":
        prm.dx += 4
    else:
        prm.rows = 1 << 31
    before = sd.launches["softmax_dropout_bwd"]
    with pytest.raises(build.KernelError, match="bwd launch failed"):
        sd._launch("bwd", prm, torch.float32, cuda)
    torch.cuda.synchronize()
    assert sd.launches["softmax_dropout_bwd"] == before


@pytest.mark.gpu
def test_forward_entry_rejects_a_mask_of_another_type(cuda):
    """The forward's C entry takes mask and bias in fp32 or in x's type
    only: an fp16 x with a bf16 mask (which ``fwd_operands`` never sends)
    is refused before any launch: KernelError, no launch counted."""
    from unicore_tpu_torch.ops import build

    x = torch.zeros((4, 128), dtype=torch.float16, device=cuda)
    mask = torch.zeros((4, 128), dtype=torch.bfloat16, device=cuda)
    out = torch.empty_like(x)
    seed = torch.tensor([1], dtype=torch.int32, device=cuda)
    prm = sd._params(4, 128, 4, 0.1, seed, 1)
    prm.x, prm.mask, prm.out = x.data_ptr(), mask.data_ptr(), out.data_ptr()
    prm.sx[:], prm.smk[:] = [0, 0, 0, 128], [0, 0, 0, 128]
    prm.L1 = prm.L2 = 1
    prm.mask_type = sd._TYPE_CODE[torch.bfloat16]
    before = sd.launches["softmax_dropout_fwd"]
    with pytest.raises(build.KernelError, match="fwd launch failed"):
        sd._launch("fwd", prm, torch.float16, cuda)
    torch.cuda.synchronize()
    assert sd.launches["softmax_dropout_fwd"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k", [128, 1024, 2048])
def test_forward_matches_plain_on_card(cuda, k, dtype):
    """The forward kernel vs the plain version at K = 128 (four lanes a
    bf16 or fp16 row), 1024 (a warp) and 2048 (a block), with a bf16 mask
    (widened to fp32 unless x is bf16) and an fp32 bias whatever x's
    type, and 210 rows (not a multiple of a block's rows): equal keep
    patterns; out and the softmax within 1e-5 (fp32) or 2e-2 of each
    tensor's max (bf16, fp16)."""
    gen = torch.Generator().manual_seed(k)
    x = torch.randn((2, 3, 5, 7, k), generator=gen).to(getattr(torch, dtype))
    mask = (((torch.rand((2, 3, 1, 1, k), generator=gen) > 0.2).float() - 1.0)
            * 1e4).bfloat16()
    bias = torch.randn((1, 1, 5, 7, k), generator=gen)
    seed = torch.tensor([777], dtype=torch.int32)
    q_blk = sd.pick_q_blk_for(x, mask, bias)
    want = sd.softmax_dropout_fwd_plain(x, mask, bias, 0.1, seed, q_blk, True)
    before = sd.launches["softmax_dropout_fwd"]
    got = sd.softmax_dropout_fwd_cuda(
        *(t.to(cuda) for t in (x, mask, bias)), 0.1, seed.to(cuda), q_blk,
        True)
    torch.cuda.synchronize()
    assert sd.launches["softmax_dropout_fwd"] == before + 1
    got = [t.cpu().float() for t in got]
    want = [t.float() for t in want]
    assert torch.equal(got[0] == 0, want[0] == 0)
    for g, w in zip(got, want):
        tol = 1e-5 if dtype == "float32" else 2e-2 * float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=0, atol=tol)


def off_grid_case(k, dtype):
    """A 4-D attention call at key width k: x, a [b, 1, 1, k] mask and a
    [1, h, q, k] bias (fp32 numpy), and the loss weights."""
    rng = np.random.RandomState(k)
    x = rng.randn(2, 3, 24, k).astype(np.float32)
    mask = ((rng.rand(2, 1, 1, k) > 0.2).astype(np.float32) - 1.0) * 1e4
    bias = rng.randn(1, 3, 24, k).astype(np.float32)
    if dtype != "float32":
        x, bias = (torch.from_numpy(a).to(getattr(torch, dtype)).float()
                   .numpy() for a in (x, bias))
    return x, mask, bias, rng.randn(2, 3, 24, k).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k,path", [(200, "plain"), (256, "kernel")])
def test_route_decides_on_card(cuda, k, path, dtype):
    """k = 200 is off the kernels' grid, where the reference runs its jnp
    path: forward and backward run the plain version on the card, counted
    in ``plain_route`` and not in ``launches``, equal to the plain version
    on the CPU (fp32 within 1e-6, bf16 within 1e-2 of each tensor's max:
    the same ops on another device).  k = 256 still launches both
    kernels."""
    case = off_grid_case(k, dtype)
    assert sd.route(*(torch.from_numpy(a) for a in case[:3])) == path
    before = dict(sd.launches), dict(sd.plain_route)
    got = port_run(case, dtype, 0.1, 4321, cuda)
    torch.cuda.synchronize()
    ran = {name: (sd.launches[name] - before[0][name],
                  sd.plain_route[name] - before[1][name])
           for name in sd.launches}
    one = (1, 0) if path == "kernel" else (0, 1)
    assert ran == {"softmax_dropout_fwd": one, "softmax_dropout_bwd": one}
    want = port_run(case, dtype, 0.1, 4321)
    np.testing.assert_array_equal(got[0] == 0, want[0] == 0)
    for g, w in zip(got, want):
        tol = (1e-6 if path == "plain" else 1e-5) if dtype == "float32" \
            else (1e-2 if path == "plain" else 2e-2) * np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.mark.gpu
def test_six_dim_x_launches_the_kernels_on_card(cuda):
    """A 6-D x, eligible as the reference's kernel takes any rank, folds
    into the kernels' five dims and launches them: equal keep pattern and
    within 1e-5 of the plain version, fp32."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 2, 3, 2, 16, 128).astype(np.float32)
    mask = ((rng.rand(2, 1, 3, 1, 1, 128) > 0.2).astype(np.float32)
            - 1.0) * 1e4
    bias = rng.randn(1, 2, 1, 2, 16, 128).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)
    before = dict(sd.launches)
    got = port_run((x, mask, bias, w), "float32", 0.1, 99, cuda)
    torch.cuda.synchronize()
    assert {n: sd.launches[n] - before[n] for n in before} == {
        "softmax_dropout_fwd": 1, "softmax_dropout_bwd": 1}
    want = port_run((x, mask, bias, w), "float32", 0.1, 99)
    np.testing.assert_array_equal(got[0] == 0, want[0] == 0)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, rtol=0, atol=1e-5)


@pytest.mark.gpu
def test_self_attention_launches_the_kernel_on_card(cuda):
    """On the card the materialized path launches the softmax_dropout
    forward and backward once each per call, within 1e-4 of the CPU."""
    from unicore_tpu_torch.modules import SelfMultiheadAttention

    rng = np.random.RandomState(9)
    query, pad, bias = attention_case(rng)
    port = SelfMultiheadAttention(query.shape[-1], 4, dropout=0.0)
    want = port(torch.from_numpy(query), torch.from_numpy(pad),
                torch.from_numpy(bias))
    port = port.to(cuda)
    qt = torch.tensor(query, device=cuda, requires_grad=True)
    before = dict(sd.launches)
    got = port(qt, torch.from_numpy(pad).to(cuda),
               torch.from_numpy(bias).to(cuda))
    got.sum().backward()
    torch.cuda.synchronize()
    assert {k: sd.launches[k] - before[k] for k in before} == {
        "softmax_dropout_fwd": 1, "softmax_dropout_bwd": 1}
    np.testing.assert_allclose(got.detach().cpu().numpy(),
                               want.detach().numpy(), rtol=0, atol=1e-4)
