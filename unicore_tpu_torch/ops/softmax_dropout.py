"""Fused bias + mask + softmax + dropout: the CUDA kernels' wrappers, their
plain versions, and the autograd function that ties them together.

Replaces the Pallas TPU kernels of ``unicore_tpu/ops/pallas/
softmax_dropout.py`` (``_fwd_kernel``, ``_bwd_kernel``) behind the JAX
package's ``ops.softmax_dropout``:

    out = dropout(softmax(x + mask + bias))

in fp32 whatever x's type (fp32, bf16 or fp16), with out (and, for the
backward, the softmax) in x's type.  mask and bias are additive and
broadcast against x, including the 5-D Evoformer contracts (mask
``[b, g, 1, 1, k]`` / ``[b, g, h, 1, k]``, bias ``[1, 1, h, q, k]`` /
``[1, g, h, q, k]``) and Uni-Mol's per-batch pair bias of x's own shape,
whose gradient is dx itself (no reduction, no copy).  The
kernels are ``unicore_tpu_torch/csrc/softmax_dropout.cu``; the dropout
bits are ``csrc/prng.cuh``.

Bound on the card: bytes (a row-local pass over memory; see the source's
note).

Dropout masks are the JAX kernel's bit for bit: element (lead..., r, c)
keeps iff its counter-hash bits under ``seed + pid`` at index
``(r % q_blk)·k + c`` fall below ``keep_prob·2^32``, where pid is the
row-major linear index over (lead dims..., r // q_blk) and q_blk is the
reference's row block (:func:`pick_q_blk_for`).  The backward recomputes
the mask from the same seed instead of storing it.

Dispatch is by the tensor's device: a CPU tensor takes the plain version
(the tests' path).  On a CUDA tensor :func:`route` decides from the
shapes alone, before anything launches, with the JAX package's own rule
(``_pallas_eligible``): a shape its dispatch sends to the Pallas kernel
launches the CUDA kernels or raises
(:class:`~unicore_tpu_torch.ops.build.KernelError`); a shape it sends to
its jnp path (``softmax_dropout_reference``: k not a multiple of 128,
k > 8192, an operand broadcast over k) runs the plain version as torch
ops on the card, counted in :data:`plain_route`, never in
:data:`launches`.  That is the reference's dispatch, not a fallback:
nothing is caught, and a kernel that fails to build or launch raises.
The JAX package's autotuner, timed probe and "eager" crossover are TPU
dispatch and are not ported.
"""

import ctypes
import functools

import torch

from . import build, prng

MAX_K = 8192
MAX_KERNEL_DIMS = 5
# x's types and the CUDA source's codes for them (SdType)
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# launches per kernel, counted where each wrapper launches its kernel
launches = {"softmax_dropout_fwd": 0, "softmax_dropout_bwd": 0}
# calls on the card that :func:`route` sent to the plain version
plain_route = {"softmax_dropout_fwd": 0, "softmax_dropout_bwd": 0}


def pick_q_blk(q, k, n_streams=4, itemsize=4):
    """The reference's row block (a copy of its ``_pick_q_blk``): the
    largest of 256, 128, ..., 8, 1 that divides q within a 6 MB budget of
    ``2 · n_streams`` blocks of ``q_blk x k``.  The port's kernels work
    row by row; this block only fixes the dropout masks."""
    budget_bytes = 6 << 20
    denom = max(1, 2 * n_streams * k * itemsize)
    blk = min(q, max(8, budget_bytes // denom))
    for cand in (256, 128, 64, 32, 16, 8, 1):
        if cand <= blk and q % cand == 0:
            return cand
    return 1


def pick_q_blk_for(x, mask, bias):
    """The one row block of a call, forward and backward alike (a copy of
    the reference's ``_pick_q_blk_for``): streams counted for the
    grad-mode forward — x, out, the saved softmax, plus mask and bias."""
    n_streams = 3 + (mask is not None) + (bias is not None)
    return pick_q_blk(x.shape[-2], x.shape[-1], n_streams=n_streams,
                      itemsize=x.element_size())


def canon(x, mask, bias):
    """Pad mask and bias to x's rank with leading 1s (the reference's
    ``_canon``)."""
    def pad(a):
        if a is None:
            return None
        return a.reshape((1,) * (x.dim() - a.dim()) + tuple(a.shape))

    return pad(mask), pad(bias)


def eligible(x, mask, bias):
    """Whether the kernels take these shapes — a copy of the reference's
    ``_pallas_eligible``: k a multiple of 128 up to 8192, and no operand
    broadcast over k."""
    k = x.shape[-1]
    if not (k % 128 == 0 and k <= MAX_K and x.dim() >= 2):
        return False
    return all(op is None or op.shape[-1] == k for op in (mask, bias))


def route(x, mask, bias):
    """``"kernel"`` where the JAX package's dispatch takes its Pallas
    kernel (:func:`eligible`), else ``"plain"`` (its jnp path); a pure
    function of the shapes, mask and bias canonicalized to x's rank."""
    return "kernel" if eligible(x, mask, bias) else "plain"


def fold_lead(x, mask, bias):
    """x, mask and bias with x's lead dims folded until x has at most
    ``MAX_KERNEL_DIMS`` dims.  Folding is row-major, so every row keeps
    its program id and so its dropout bits; dims where x has size 1 go
    first, then the pair of neighbours that the fewest operands broadcast
    over one of but not the other (such an operand is expanded over the
    pair, a copy)."""
    mask, bias = canon(x, mask, bias)
    keep = [d for d in range(x.dim() - 2) if x.shape[d] != 1]
    if x.dim() > MAX_KERNEL_DIMS and len(keep) < x.dim() - 2:
        def squeeze(a):
            return None if a is None else a.reshape(
                [a.shape[d] for d in keep] + list(a.shape[-2:]))
        x, mask, bias = squeeze(x), squeeze(mask), squeeze(bias)
    while x.dim() > MAX_KERNEL_DIMS:
        def copies(i):
            return sum(op is not None and (op.shape[i] == 1)
                       != (op.shape[i + 1] == 1) for op in (mask, bias))

        i = min(range(x.dim() - 3), key=copies)

        def fold(a):
            if a is None:
                return None
            shape = list(a.shape)
            if shape[i] == shape[i + 1] == 1:
                return a.reshape(shape[:i] + [1] + shape[i + 2:])
            shape[i:i + 2] = x.shape[i:i + 2]
            return a.expand(shape).reshape(
                shape[:i] + [shape[i] * shape[i + 1]] + shape[i + 2:])
        x, mask, bias = fold(x), fold(mask), fold(bias)
    return x, mask, bias


# ---------------------------------------------------------------- plain --

def keep_mask(seed, shape, q_blk, keep_prob):
    """Boolean keep mask of the reference's kernel for an x of ``shape``
    and a one-element int32 ``seed``."""
    *lead, q, k = shape
    dev = seed.device
    n_lead = 1
    for s in lead:
        n_lead *= s
    lin = torch.arange(n_lead, dtype=torch.int64, device=dev).reshape(
        tuple(lead) + (1, 1))
    r = torch.arange(q, dtype=torch.int64, device=dev)[:, None]
    c = torch.arange(k, dtype=torch.int64, device=dev)[None, :]
    pid = lin * (q // q_blk) + r // q_blk                     # [..., q, 1]
    bits = prng.random_bits(seed.reshape(()).long() + pid,
                            (r % q_blk) * k + c)
    return bits < prng.keep_threshold(keep_prob)


def softmax_dropout_fwd_plain(x, mask, bias, dropout_prob, seed, q_blk,
                              save_softmax):
    """The forward kernel's function in plain PyTorch: ``(out, softmax or
    None)``, both in x's dtype."""
    z = x.float()
    if mask is not None:
        z = z + mask.float()
    if bias is not None:
        z = z + bias.float()
    e = torch.exp(z - z.amax(dim=-1, keepdim=True))
    y = e / e.sum(dim=-1, keepdim=True)
    sm = y.to(x.dtype) if save_softmax else None
    if dropout_prob > 0.0:
        keep_prob = 1.0 - dropout_prob
        keep = keep_mask(seed, tuple(y.shape), q_blk, keep_prob)
        y = torch.where(keep, y * (1.0 / keep_prob), 0.0)
    return y.to(x.dtype), sm


def softmax_dropout_bwd_plain(g, sm, dropout_prob, seed, q_blk):
    """The backward kernel's function in plain PyTorch: dx in the saved
    softmax's dtype."""
    g = g.float()
    y = sm.float()
    if dropout_prob > 0.0:
        keep_prob = 1.0 - dropout_prob
        keep = keep_mask(seed, tuple(y.shape), q_blk, keep_prob)
        g = torch.where(keep, g * (1.0 / keep_prob), 0.0)
    dx = y * (g - (g * y).sum(dim=-1, keepdim=True))
    return dx.to(sm.dtype)


# --------------------------------------------------------------- kernels --

class _Params(ctypes.Structure):
    """``SoftmaxDropoutParams`` of the CUDA source, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("x", "mask", "bias", "seed", "out", "sm", "g", "dx")]
                + [(n, ctypes.c_longlong * 4) for n in ("sx", "smk", "sb")]
                + [("rows", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in
                   ("L1", "L2", "Q", "K", "mask_type", "bias_type",
                    "dropout", "q_blk")]
                + [("inv_keep", ctypes.c_float),
                   ("keep_thresh", ctypes.c_uint32)])


@functools.cache
def _entry(name):
    fn = getattr(build.load("softmax_dropout"),
                 f"unicore_softmax_dropout_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_int, ctypes.c_void_p]
    return fn


def _launch(name, params, dtype, device):
    """Launch pass ``name`` for x (or sm) of ``dtype``."""
    fn = _entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.byref(params), _TYPE_CODE[dtype], stream)
    if err:
        raise build.KernelError(
            f"softmax_dropout kernel {name} launch failed: CUDA error {err}")
    launches[f"softmax_dropout_{name}"] += 1


def _lead5(shape):
    """A shape of rank <= 5 with leading 1s up to rank 5."""
    return (1,) * (MAX_KERNEL_DIMS - len(shape)) + tuple(shape)


def _bcast_strides(op, x_shape5, name):
    """Strides of an operand over (L0, L1, L2, Q), 0 on a dim of size 1,
    and the operand as the forward's 16-byte runs read it
    (:func:`~unicore_tpu_torch.ops.build.aligned16`)."""
    if op.stride(-1) != 1:
        op = op.contiguous()
    op = build.aligned16(op, strided=True)
    shape5 = _lead5(op.shape)
    strides5 = (0,) * (MAX_KERNEL_DIMS - op.dim()) + tuple(op.stride())
    out = []
    for d in range(4):
        if shape5[d] == x_shape5[d]:
            out.append(strides5[d] if shape5[d] != 1 else 0)
        elif shape5[d] == 1:
            out.append(0)
        else:
            raise ValueError(f"softmax_dropout {name} {tuple(op.shape)} does "
                             f"not broadcast against x {x_shape5}")
    return op, out


def _params(q, k, rows, dropout_prob, seed, q_blk):
    prm = _Params()
    prm.seed = seed.data_ptr()
    prm.rows, prm.Q, prm.K, prm.q_blk = rows, q, k, q_blk
    prm.dropout = int(dropout_prob > 0.0)
    keep_prob = 1.0 - dropout_prob
    prm.inv_keep = 1.0 / keep_prob if dropout_prob > 0.0 else 1.0
    prm.keep_thresh = prng.keep_threshold(keep_prob)
    return prm


def _check(x, mask, bias, seed):
    if x.dtype not in _TYPE_CODE:
        raise TypeError(f"softmax_dropout kernels take float32, bfloat16 "
                        f"or float16 x, got {x.dtype}")
    for op in (mask, bias, seed):
        if op is not None and op.device != x.device:
            raise ValueError(f"all operands must be on {x.device}, got one "
                             f"on {op.device}")
    if route(x, mask, bias) != "kernel":
        raise ValueError(
            f"softmax_dropout kernels take k a multiple of 128 up to "
            f"{MAX_K} and no operand broadcast over k (route() sends other "
            f"shapes to the plain version); got x {tuple(x.shape)}, mask "
            f"{None if mask is None else tuple(mask.shape)}, bias "
            f"{None if bias is None else tuple(bias.shape)}")


def fwd_operands(x, mask, bias):
    """x, mask and bias as the forward kernel reads them: ``(x, x's
    strides over (L0, L1, L2, Q), [(name, operand, strides), ...])``.
    mask and bias in fp32 or in x's type (any other type widened to
    fp32, exactly: the kernels add them in fp32), each operand with a
    unit last dim, its address and strides multiples of 16 bytes (else a
    contiguous copy), strides 0 on dims of size 1 (mask and bias: on
    their broadcast dims)."""
    x, sx = _bcast_strides(x, _lead5(x.shape), "x")
    ops = []
    for name, op in (("mask", mask), ("bias", bias)):
        if op is None:
            continue
        if op.dtype not in (torch.float32, x.dtype):
            op = op.float()
        ops.append((name, *_bcast_strides(op, _lead5(x.shape), name)))
    return x, sx, ops


def softmax_dropout_fwd_cuda(x, mask, bias, dropout_prob, seed, q_blk,
                             save_softmax):
    """Launch the forward kernel: ``(out, softmax or None)`` as
    :func:`softmax_dropout_fwd_plain`, the operands as
    :func:`fwd_operands` gives them, lead dims folded by
    :func:`fold_lead`."""
    _check(x, mask, bias, seed)
    shape = x.shape
    x, sx, ops = fwd_operands(*fold_lead(x, mask, bias))
    x5 = _lead5(x.shape)
    q, k = x5[3], x5[4]
    rows = x.numel() // k
    prm = _params(q, k, rows, dropout_prob, seed, q_blk)
    prm.x = x.data_ptr()
    prm.sx[:] = sx
    prm.L1, prm.L2 = x5[1], x5[2]
    for name, op, strides in ops:  # ops stays alive until the launch
        setattr(prm, name, op.data_ptr())
        getattr(prm, {"mask": "smk", "bias": "sb"}[name])[:] = strides
        setattr(prm, f"{name}_type", _TYPE_CODE[op.dtype])
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    sm = torch.empty_like(out) if save_softmax else None
    prm.out = out.data_ptr()
    prm.sm = sm.data_ptr() if sm is not None else None
    _launch("fwd", prm, x.dtype, x.device)
    return out.reshape(shape), None if sm is None else sm.reshape(shape)


def bwd_operands(g, sm):
    """g and sm as the backward kernel reads them: ``(g, sm)``, g in sm's
    dtype, both contiguous at addresses that are multiples of 16 bytes
    (else a copy).  The kernel reads both, and writes dx, in runs of 16
    bytes; k is a multiple of 128, so every row starts on 16 bytes too.
    A contiguous view at an odd storage offset is contiguous but
    misaligned: it is copied."""
    return (build.aligned16(g.to(sm.dtype).contiguous()),
            build.aligned16(sm.contiguous()))


def softmax_dropout_bwd_cuda(g, sm, dropout_prob, seed, q_blk):
    """Launch the backward kernel: dx as :func:`softmax_dropout_bwd_plain`,
    g and sm as :func:`bwd_operands` gives them, dx a fresh (so aligned)
    tensor.  The kernel works on the forward's split of a row, each lane
    reading its runs of g and sm and writing its runs of dx 16 bytes at
    a time; where several rows share a warp, a lane past the last row
    takes part in the row's reductions on the last row and stores
    nothing."""
    g, sm = bwd_operands(g, sm)
    q, k = sm.shape[-2], sm.shape[-1]
    dx = torch.empty_like(sm)
    prm = _params(q, k, sm.numel() // k, dropout_prob, seed, q_blk)
    prm.g, prm.sm, prm.dx = g.data_ptr(), sm.data_ptr(), dx.data_ptr()
    _launch("bwd", prm, sm.dtype, sm.device)
    return dx


def check_backward(dx, g, sm, dropout_prob, seed, q_blk, dbias=None):
    """Hold a backward's dx against :func:`softmax_dropout_bwd_plain` of
    the same g, sm, seed and q_blk, element by element, and with
    ``dbias`` also dx reduced over a broadcast bias as the autograd
    function reduces it.  Test support (the card tests and
    ``chip_smoke.py``); nothing on the main path calls it.

    Two correct backwards differ only in the order of the row's fp32 dot
    and in rounding, so at every element, with y = sm, g' = g after the
    plain version's keep bits, dot = Σ_c g'·y and ε = the ulp of 1 in
    dx's dtype:

        |dx − plain| ≤ (1 + ε)·(d + ε·|plain|),
        d = |y|·(K·2^-22·Σ_c |g'·y| + 2^-21·(|g'| + |dot|)):

    K·2^-22·Σ|g'·y| bounds two fp32 sums of K products in any order
    (K·2^-23 each, with room for g' rounded apart on each side); 2^-21
    the subtraction, the product and g' = g·inv_keep rounded on each
    side; (1 + ε)(· + ε·|plain|) the rounding of both results to dx's
    dtype, plus one step of its subnormal range (fp16's 2^-24, where
    rounding is absolute, not relative).  A wrong keep bit moves its
    element by |y·g|·inv_keep, far above d wherever g ≠ 0 and y·g is
    above that step, however small y is.  The reduced dbias is
    held within the sum of dx's bounds over the summed elements, two fp32
    sums of n terms (n·2^-23 of the summed magnitudes), and the rounding
    to its dtype.

    Returns ``{"dx": max |dx − plain|}`` (and ``"dbias"``); raises
    AssertionError naming the worst element otherwise."""
    want = softmax_dropout_bwd_plain(g, sm, dropout_prob, seed, q_blk)
    y = sm.float()
    gp = g.float()
    if dropout_prob > 0.0:
        keep_prob = 1.0 - dropout_prob
        keep = keep_mask(seed, tuple(y.shape), q_blk, keep_prob)
        gp = torch.where(keep, gp * (1.0 / keep_prob), 0.0)
    gy = gp * y
    dot = gy.sum(dim=-1, keepdim=True)
    d = y.abs() * (y.shape[-1] * 2.0 ** -22 * gy.abs().sum(
        dim=-1, keepdim=True) + 2.0 ** -21 * (gp.abs() + dot.abs()))
    del y, gp, gy
    bound = _bound(d, want, dx.dtype)
    errs = {"dx": _held("dx", dx, want, bound)}
    if dbias is not None:
        shape = (1,) * (dx.dim() - dbias.dim()) + tuple(dbias.shape)
        axes = [i for i, (s, xs) in enumerate(zip(shape, dx.shape))
                if s == 1 and xs != 1]
        n = dx.numel() // dbias.numel()

        def total(t):
            return t.sum(dim=axes, keepdim=True) if axes else t

        b_sum, mag = total(bound), total(want.float().abs())
        want_db = _reduce_to(want, shape, dbias.dtype)
        errs["dbias"] = _held(
            "dbias", dbias.reshape(shape), want_db,
            _bound(b_sum + n * 2.0 ** -23 * (mag + b_sum), want_db,
                   dx.dtype, dbias.dtype))
    return errs


def _bound(d, want, *dtypes):
    """(1 + eps)·(d + eps·|want|) + step: d, then both sides rounded to
    ``dtypes`` (eps the largest relative ulp among them; step the largest
    spacing of their subnormal ranges, at least fp32's least normal, for
    values near 0)."""
    eps = max(torch.finfo(t).eps for t in dtypes)
    step = max([torch.finfo(torch.float32).tiny]
               + [torch.finfo(t).tiny * torch.finfo(t).eps for t in dtypes])
    return (1 + eps) * (d + eps * want.float().abs()) + step


def _held(what, got, want, bound):
    """max |got − want|, after checking it within ``bound`` at every
    element (a NaN fails)."""
    want = want.float()
    err = (got.float() - want).abs()
    bad = ~(err <= bound)
    if bad.any():
        i = int(torch.argmax((err / bound).masked_fill(
            torch.isnan(err), float("inf")).reshape(-1)))
        idx = tuple(int(v) for v in torch.unravel_index(
            torch.tensor(i), err.shape))
        raise AssertionError(
            f"softmax_dropout backward: {what} off the plain version's "
            f"(a wrong keep bit?) at {int(bad.sum())} of {err.numel()} "
            f"elements; worst at {idx}: got {float(got.reshape(-1)[i])}, "
            f"want {float(want.reshape(-1)[i])}, bound "
            f"{float(bound.reshape(-1)[i])}")
    return float(err.max()) if err.numel() else 0.0


# -------------------------------------------------------------- autograd --

def _path(x, mask, bias):
    """``"cpu"`` for a CPU tensor, else the card's :func:`route`."""
    if x.device.type == "cpu":
        return "cpu"
    if x.device.type == "cuda":
        return route(x, mask, bias)
    raise ValueError(f"softmax_dropout has no path for {x.device}")


def _run(path, name, plain, cuda):
    if path == "plain":
        plain_route[f"softmax_dropout_{name}"] += 1
    return cuda if path == "kernel" else plain


def _reduce_to(dx, shape, dtype):
    """dx summed in fp32 over the dims an operand of ``shape`` broadcasts,
    cast to dx's dtype (the reference's ``reduce_to``), then to the
    operand's ``dtype``.  An operand of x's shape broadcasts over no dim:
    its gradient is dx, a view of it in dx's dtype (the reference's sum
    over no axes is dx unchanged)."""
    axes = [i for i, (s, xs) in enumerate(zip(shape, dx.shape))
            if s == 1 and xs != 1]
    if not axes:
        return dx.reshape(shape).to(dtype)
    r = dx.sum(dim=axes, keepdim=True, dtype=torch.float32)
    return r.reshape(shape).to(dx.dtype).to(dtype)


class _SoftmaxDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask, bias, dropout_prob, seed, q_blk, save):
        path = _path(x, mask, bias)
        fwd = _run(path, "fwd", softmax_dropout_fwd_plain,
                   softmax_dropout_fwd_cuda)
        out, sm = fwd(x, mask, bias, dropout_prob, seed, q_blk, save)
        ctx.save_for_backward(sm, seed)
        ctx.args = (path, dropout_prob, q_blk,
                    None if mask is None else (mask.shape, mask.dtype),
                    None if bias is None else (bias.shape, bias.dtype))
        return out

    @staticmethod
    def backward(ctx, g):
        sm, seed = ctx.saved_tensors
        if sm is None:
            raise RuntimeError("softmax_dropout: the forward ran without "
                               "grad mode and saved no softmax")
        path, dropout_prob, q_blk, mask_meta, bias_meta = ctx.args
        bwd = _run(path, "bwd", softmax_dropout_bwd_plain,
                   softmax_dropout_bwd_cuda)
        dx = bwd(g, sm, dropout_prob, seed, q_blk)
        grads = [dx if ctx.needs_input_grad[0] else None]
        for i, meta in ((1, mask_meta), (2, bias_meta)):
            grads.append(_reduce_to(dx, *meta)
                         if meta is not None and ctx.needs_input_grad[i]
                         else None)
        return (*grads, None, None, None, None)


def softmax_dropout(x, dropout_prob, is_training=True, mask=None, bias=None,
                    generator=None, seed=None):
    """``dropout(softmax(x + mask + bias))`` over x's last dim (the JAX
    package's ``softmax_dropout`` minus ``return_softmax`` and the
    autotuner's ``q_blk``).  With dropout on, the int32 seed is ``seed``
    when given, else drawn from ``generator``."""
    mask, bias = canon(x, mask, bias)
    p = float(dropout_prob) if is_training else 0.0
    if p > 0.0:
        if seed is None:
            if generator is None:
                raise ValueError("softmax_dropout: a generator or seed is "
                                 "required when training with dropout")
            seed = prng.draw_seeds(generator, (1,))
        seed = torch.as_tensor(seed, dtype=torch.int32).reshape(1).to(
            x.device)
    else:
        seed = torch.zeros((1,), dtype=torch.int32, device=x.device)
    save = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, mask, bias))
    return _SoftmaxDropout.apply(x, mask, bias, p, seed,
                                 pick_q_blk_for(x, mask, bias), save)
