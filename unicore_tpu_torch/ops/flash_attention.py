"""Flash attention: the CUDA kernels' wrappers, their plain versions, and
the autograd function that ties them together.

Replaces the Pallas TPU kernels of ``unicore_tpu/ops/pallas/
flash_attention.py`` — the single-block head-batched forward and fused
backward (``_fwd_hb_kernel``, ``_bwd_hb_kernel``) that BERT at T = 512
takes, and the multi-block forward and dq/dkv/joint/dbias passes of
longer sequences.  The kernels: for bf16 and fp16 operands, the training
paths (``--bf16``, ``--fp16``), ``unicore_tpu_torch/csrc/
flash_attention_fwd.cu`` holds the tensor-core forward and
``csrc/flash_attention_bwd.cu`` the tensor-core backward in two kernels
(dk/dv; dq with the dbias partials of a batch group), both built from
``csrc/mma_bf16.cuh`` and instantiated once per operand type; for fp32
operands
``csrc/flash_attention.cu`` holds the forward and the backward (dk/dv,
dq and dbias passes, fp32 FMA on the CUDA cores).  All share
``csrc/flash_params.cuh``; the dropout bits are ``csrc/prng.cuh``.

Bound on the card: arithmetic.  The forward needs 4·B·H·Tq·Tk·D flops and
the backward 10·B·H·Tq·Tk·D, against the tensor-core rate for bf16 and
fp16 operands and the fp32 rate for fp32 ones (see the sources' notes).

Semantics are the JAX function's, including its dropout masks bit for
bit: element (b, h, r, c) keeps iff its counter-hash bits under seed
``seed[b] + (h·n_i + i)·n_j + j`` at index ``(r % bq)·bk + c % bk`` fall
below ``keep_prob·2^32``, where (bq, bk) is the reference's block
geometry (:func:`pick_blocks`) and i, j the block of (r, c).

Dispatch is by the tensor's device: a CPU tensor takes the plain version
(the tests' path), a CUDA tensor launches the kernels or raises
(:class:`~unicore_tpu_torch.ops.build.KernelError`, or
``NotImplementedError`` for shapes the kernels do not take).  There is
no fallback from a kernel to the plain version.
"""

import ctypes
import functools

import torch

from . import build, prng

NEG_INF = -1e30
MAX_KERNEL_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
# the tensor-core kernels' operand types, and the suffix of each one's
# kernel names (the bf16 kernels' names predate the fp16 ones)
_TENSOR_CORE = {torch.bfloat16: "", torch.float16: "_fp16"}
# FlashParams::bias_type (csrc/flash_params.cuh)
_BIAS_TYPE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# launches per kernel, counted where each wrapper launches its kernel:
# the fp32 forward and backward (three kernels); the bf16 and the fp16
# forward and backward (two kernels each)
launches = {"flash_fwd": 0, "flash_dkdv": 0, "flash_dq": 0,
            "flash_dbias": 0, "flash_fwd_bf16": 0, "flash_bwd_dkdv": 0,
            "flash_bwd_dq": 0, "flash_fwd_fp16": 0, "flash_bwd_dkdv_fp16": 0,
            "flash_bwd_dq_fp16": 0}

# the tensor-core kernels' tiling (csrc/mma_bf16.cuh): 64-row tiles, D
# zero-filled to 32, 64 or 128; at most 32 batch rows a dq group
BWD_TILE, BWD_MAX_ROWS = 64, 32
SMS = 132                    # H100 SXM
SMEM_BLOCK = 232448          # shared memory one block may use
SMEM_SM = 233472             # of an SM, 1 KB of it reserved per block


def eligible(q_shape, k_shape, bias_shape):
    """Whether flash supports these shapes ([B, H, T, D] layout) — a copy
    of the JAX package's rule."""
    _, _, tq, d = q_shape
    tk = k_shape[2]
    if tq % 128 != 0 or tk % 128 != 0:
        return False
    if d > 256 or d % 8 != 0:
        return False
    if bias_shape is not None:
        if len(bias_shape) != 4:
            return False
        bB, bH, bQ, bK = bias_shape
        # batch-broadcast bias only (dbias is summed over the batch)
        if bB != 1 or bK != tk or bQ not in (1, tq):
            return False
    return True


def pick_blocks(tq, tk, bias_itemsize=0):
    """The reference's (block_q, block_k) — a copy of its
    ``_pick_blocks`` without the autotune cache.  The port's kernels tile
    differently; this geometry only fixes the dropout masks."""
    def pick(t, cands):
        for c in cands:
            if c <= t and t % c == 0:
                return c
        return t

    bq = pick(tq, (512, 384, 256, 128))
    budget_el = (1 << 20) if bias_itemsize == 0 else (
        (1 << 20) * 2 // (2 + bias_itemsize))
    budget = budget_el // bq
    bk = pick(tk, tuple(
        c for c in (tk, 2048, 1536, 1024, 768, 512, 384, 256, 128)
        if c <= budget))
    return bq, bk


def geometry(tq, tk, bias):
    """The mask geometry of a call: :func:`pick_blocks` with the bias's
    item size, counted only for a bias with a full query dim (as the
    reference's ``picked_blocks``)."""
    itemsize = (bias.element_size()
                if bias is not None and bias.shape[2] != 1 else 0)
    return pick_blocks(tq, tk, itemsize)


# ---------------------------------------------------------------- plain --

def keep_mask(seed, heads, tq, tk, geom, keep_prob):
    """[B, H, Tq, Tk] keep mask of the reference's kernels for per-row
    seeds ``seed`` [B] int32."""
    bq, bk = geom
    n_i, n_j = tq // bq, tk // bk
    dev = seed.device
    r = torch.arange(tq, device=dev, dtype=torch.int64)
    c = torch.arange(tk, device=dev, dtype=torch.int64)
    h = torch.arange(heads, device=dev, dtype=torch.int64)
    block = ((h[:, None, None] * n_i + (r // bq)[None, :, None]) * n_j
             + (c // bk)[None, None, :])                       # [H, Tq, Tk]
    idx = (r % bq)[:, None] * bk + (c % bk)[None, :]          # [Tq, Tk]
    bits = prng.random_bits(seed.long()[:, None, None, None] + block[None],
                            idx)
    return bits < prng.keep_threshold(keep_prob)


def _scores(q, k, bias, pad, causal, scale):
    """fp32 [B, H, Tq, Tk] scores with the bias, pad and causal terms
    added in the kernels' order."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    if pad is not None:
        s = s + torch.where(pad[:, None, None, :] > 0, NEG_INF, 0.0)
    if causal:
        tq, tk = s.shape[-2:]
        rows = torch.arange(tq, device=s.device)[:, None]
        cols = torch.arange(tk, device=s.device)[None, :]
        s = s + torch.where(cols > rows, NEG_INF, 0.0)
    return s


def flash_fwd_plain(q, k, v, bias, pad, dropout_prob, seed, causal, scale,
                    geom):
    """The forward kernel's function in plain PyTorch: ``(out [B, Tq, H,
    D] in q's dtype, lse [B, H, Tq] fp32)``.  ``l`` sums the undropped
    fp32 p; only the p·V product sees the mask and the 1/keep_prob scale.
    For operands narrower than fp32 that product sees p rounded to v's
    dtype, where the reference casts (its ``p_use.astype(v.dtype)``).

    Keys go in the reference's key blocks (``geom[1]``) with its online
    rescale: block j's p is ``exp(s - m_j)`` under the running max m_j,
    so p is rounded where the multi-block reference rounds it.  With one
    key block (BERT's T = 512) this is the single-pass softmax."""
    s = _scores(q, k, bias, pad, causal, scale)
    keep = None
    if dropout_prob > 0.0:
        keep_prob = 1.0 - dropout_prob
        keep = keep_mask(seed, q.shape[2], q.shape[1], k.shape[1], geom,
                         keep_prob)
    vf = v.float()
    m = l = acc = None
    for j0 in range(0, k.shape[1], geom[1]):
        sj = s[..., j0:j0 + geom[1]]
        m_new = sj.amax(dim=-1, keepdim=True)
        if m is not None:
            m_new = torch.maximum(m, m_new)
        p = torch.exp(sj - m_new)
        if keep is not None:
            p_use = torch.where(keep[..., j0:j0 + geom[1]],
                                p * (1.0 / keep_prob), 0.0)
        else:
            p_use = p
        if v.dtype != torch.float32:
            p_use = p_use.to(v.dtype).float()
        pv = torch.einsum("bhqk,bkhd->bhqd", p_use,
                          vf[:, j0:j0 + geom[1]])
        if m is None:
            l, acc = p.sum(dim=-1, keepdim=True), pv
        else:
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + pv
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def flash_bwd_plain(q, k, v, bias, pad, dropout_prob, seed, causal, scale,
                    geom, lse, delta, dout, want_dbias):
    """The backward kernels' function in plain PyTorch: ``(dq, dk, dv,
    dbias_full)`` with dbias_full the batch-summed [H, Tq, Tk] fp32 (or
    None).  p is recomputed from ``lse``; dP is masked and scaled as p
    was; dS = p·(dP − delta) with the undropped p.  For operands narrower
    than fp32 the products see p_drop and dS rounded to the operand type,
    and dbias sums the fp32 dS, where the reference casts."""
    s = _scores(q, k, bias, pad, causal, scale)
    p = torch.exp(s - lse[..., None])
    do = dout.float()
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v.float())
    p_drop = p
    if dropout_prob > 0.0:
        keep_prob = 1.0 - dropout_prob
        keep = keep_mask(seed, q.shape[2], q.shape[1], k.shape[1], geom,
                         keep_prob)
        p_drop = torch.where(keep, p * (1.0 / keep_prob), 0.0)
        dp = torch.where(keep, dp * (1.0 / keep_prob), 0.0)
    ds = p * (dp - delta[..., None])
    p_mm, ds_mm = p_drop, ds
    if q.dtype != torch.float32:
        p_mm, ds_mm = p_drop.to(q.dtype).float(), ds.to(q.dtype).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p_mm, do)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_mm, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_mm, q.float()) * scale
    dbias = ds.sum(dim=0) if want_dbias else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


def group_rows(bsz, groups):
    """The batch rows of each dq group of the tensor-core backward: group
    g takes rows g·B/G up to (g+1)·B/G (integer division), as the kernel
    does."""
    return [range(g * bsz // groups, (g + 1) * bsz // groups)
            for g in range(groups)]


def sum_partials(parts):
    """The batch-summed dbias from the dq kernel's per-group partials
    [G, H, Tq, Tk]: the groups added in index order (no atomics)."""
    return parts[0] if parts.shape[0] == 1 else parts.sum(dim=0)


def _bwd_head_dim(d):
    return 32 if d <= 32 else 64 if d <= 64 else 128


def fwd_smem_bytes(d, bias_itemsize):
    """Dynamic shared memory of the tensor-core forward kernel (its
    ``fwd_smem``): double-buffered k and v tiles (the q tile shares stage
    1's k), bias tiles of ``bias_itemsize``-byte elements (0: no bias) and
    pad."""
    ld = _bwd_head_dim(d) + 8
    bias = (2 * BWD_TILE * (BWD_TILE * bias_itemsize + 16)
            if bias_itemsize else 0)
    return 4 * BWD_TILE * ld * 2 + bias + 2 * BWD_TILE * 4


def dq_smem_bytes(d, rows):
    """Dynamic shared memory of the tensor-core dq kernel (its
    ``dq_smem``): double-buffered k and v tiles and pad, and for each batch
    row of the group its q and dO tiles, lse, delta and fp32 dq
    accumulator."""
    ld = _bwd_head_dim(d) + 8
    tile = BWD_TILE * ld * 2
    return (4 * tile + 2 * BWD_TILE * 4
            + rows * (2 * tile + BWD_TILE * ld * 4 + 2 * BWD_TILE * 4))


def pick_groups(bsz, tq, heads, d, want_dbias):
    """Batch groups G of the tensor-core dq kernel (grid: query tiles x
    heads x G).  Without a bias gradient G = B, one row a block.  With it,
    enough groups that the grid fills every SM twice, and few enough rows
    a group that two blocks fit an SM's shared memory (one, where a single
    row's accumulator already does not)."""
    if not want_dbias:
        return bsz
    fill = -(-2 * SMS // ((tq // BWD_TILE) * heads))
    two = SMEM_SM // 2 - 1024
    budget = two if dq_smem_bytes(d, 1) <= two else SMEM_BLOCK
    rows = 1
    while rows < BWD_MAX_ROWS and dq_smem_bytes(d, rows + 1) <= budget:
        rows += 1
    return max(1, min(bsz, max(fill, -(-bsz // rows))))


# --------------------------------------------------------------- kernels --

_PTRS = ("q", "k", "v", "bias", "pad", "seed", "out", "lse", "dout",
         "delta", "dq", "dk", "dv", "dbias")
_STRIDES = ("sq_b", "sq_t", "sq_h", "sk_b", "sk_t", "sk_h", "sv_b", "sv_t",
            "sv_h", "sd_b", "sd_t", "sd_h", "sb_h", "sb_q")
_INTS = ("B", "H", "Tq", "Tk", "D", "bias_type", "causal", "dropout",
         "geo_bq", "geo_bk", "geo_ni", "geo_nj", "groups")


class _Params(ctypes.Structure):
    """``FlashParams`` of ``csrc/flash_params.cuh``, field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [(n, ctypes.c_longlong) for n in _STRIDES]
                + [(n, ctypes.c_int) for n in _INTS]
                + [("scale", ctypes.c_float), ("inv_keep", ctypes.c_float),
                   ("keep_thresh", ctypes.c_uint32)])


# the source of each kernel's entry: the bf16 and fp16 forward and
# backward on the tensor cores, the fp32 kernels on the CUDA cores
_SOURCES = {"fwd_bf16": "flash_attention_fwd",
            "fwd_fp16": "flash_attention_fwd",
            "bwd_dkdv": "flash_attention_bwd",
            "bwd_dq": "flash_attention_bwd",
            "bwd_dkdv_fp16": "flash_attention_bwd",
            "bwd_dq_fp16": "flash_attention_bwd"}


@functools.cache
def _entry(name):
    """``unicore_flash_<name>(params, stream)`` of its source."""
    lib = build.load(_SOURCES.get(name, "flash_attention"))
    fn = getattr(lib, f"unicore_flash_{name}")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    return fn


def _launch(name, params, device):
    """Launch kernel ``name`` on the device's current stream."""
    fn = _entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.byref(params), stream)
    if err:
        raise build.KernelError(
            f"flash attention kernel {name} launch failed: CUDA error {err}")
    launches[f"flash_{name}"] += 1


def _last_dim_unit(x):
    return x if x.stride(-1) == 1 else x.contiguous()


def _check(q, k, v, bias, pad, seed, causal):
    """Raise unless the operands fit the kernels."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash kernels take float32, bfloat16 or float16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if bias is not None and (bias.dtype not in _DTYPES or (
            q.dtype in _TENSOR_CORE
            and bias.dtype not in (torch.float32, q.dtype))):
        raise TypeError(f"flash bias must be float32 or of q's dtype, got "
                        f"{bias.dtype} for {q.dtype} q")
    dev = q.device
    for x in (k, v, bias, pad, seed):
        if x is not None and x.device != dev:
            raise ValueError(f"all operands must be on {dev}, got one on "
                             f"{x.device}")
    bsz, tq, heads, d = q.shape
    if k.shape != v.shape or k.shape[0] != bsz or k.shape[2:] != (heads, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    tk = k.shape[1]
    qs, ks = (bsz, heads, tq, d), (bsz, heads, tk, d)
    if not eligible(qs, ks, None if bias is None else tuple(bias.shape)):
        raise NotImplementedError(
            f"flash attention on the card takes eligible shapes only (q "
            f"{qs}, k {ks}, bias "
            f"{None if bias is None else tuple(bias.shape)}); callers take "
            "other shapes through the materialized softmax_dropout path")
    if d > MAX_KERNEL_HEAD_DIM:
        raise NotImplementedError(
            f"head_dim {d} > {MAX_KERNEL_HEAD_DIM}: the flash kernels hold "
            "at most 128 (ROADMAP.md B2)")
    if bias is not None and bias.shape[1] not in (1, heads):
        raise ValueError(f"bias heads {bias.shape[1]} must be 1 or {heads}")
    if causal and tq != tk:
        raise ValueError(f"causal flash requires tq == tk, got {tq} != {tk}")


def _params(q, k, v, bias, pad, seed, dropout_prob, causal, scale, geom):
    bsz, tq, heads, d = q.shape
    tk = k.shape[1]
    prm = _Params()
    prm.q, prm.k, prm.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    prm.sq_b, prm.sq_t, prm.sq_h = q.stride()[:3]
    prm.sk_b, prm.sk_t, prm.sk_h = k.stride()[:3]
    prm.sv_b, prm.sv_t, prm.sv_h = v.stride()[:3]
    if bias is not None:
        prm.bias = bias.data_ptr()
        prm.bias_type = _BIAS_TYPE[bias.dtype]
        prm.sb_h = bias.stride(1) if bias.shape[1] != 1 else 0
        prm.sb_q = bias.stride(2) if bias.shape[2] != 1 else 0
    if pad is not None:
        prm.pad = pad.data_ptr()
    prm.seed = seed.data_ptr()
    prm.B, prm.H, prm.Tq, prm.Tk, prm.D = bsz, heads, tq, tk, d
    prm.causal, prm.dropout = int(causal), int(dropout_prob > 0.0)
    prm.geo_bq, prm.geo_bk = geom
    prm.geo_ni, prm.geo_nj = tq // geom[0], tk // geom[1]
    prm.scale = scale
    keep_prob = 1.0 - dropout_prob
    prm.inv_keep = 1.0 / keep_prob if dropout_prob > 0.0 else 1.0
    prm.keep_thresh = prng.keep_threshold(keep_prob)
    return prm


def _operands(q, k, v, bias, pad, seed):
    """Operands as the kernels read them: q, k, v by strides with a unit
    last dim; bias with contiguous rows; pad and seed contiguous int32."""
    q, k, v = (_last_dim_unit(x) for x in (q, k, v))
    if bias is not None:
        bias = bias.contiguous()
    if pad is not None:
        pad = pad.to(torch.int32).contiguous()
    return q, k, v, bias, pad, seed.to(torch.int32).contiguous()


def _tiles_aligned(q, k, v, bias, pad, dout=None):
    """The tensor-core kernels' operands as their 16-byte copies read
    them."""
    q, k, v = (build.aligned16(x, strided=True) for x in (q, k, v))
    if dout is not None:
        dout = build.aligned16(dout, strided=True)
    if pad is not None:
        pad = build.aligned16(pad)
    if bias is not None:
        bias = build.aligned16(bias, strided=True)
    return q, k, v, bias, pad, dout


def flash_fwd_cuda(q, k, v, bias, pad, dropout_prob, seed, causal, scale,
                   geom):
    """Launch the forward kernel: ``(out, lse)`` as
    :func:`flash_fwd_plain`.  bf16 and fp16 operands take the tensor-core
    kernel of their type, fp32 ones the fp32 kernel."""
    _check(q, k, v, bias, pad, seed, causal)
    q, k, v, bias, pad, seed = _operands(q, k, v, bias, pad, seed)
    tc = q.dtype in _TENSOR_CORE
    if tc:
        q, k, v, bias, pad, _ = _tiles_aligned(q, k, v, bias, pad)
    bsz, tq, heads, d = q.shape
    out = torch.empty((bsz, tq, heads, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((bsz, heads, tq), dtype=torch.float32, device=q.device)
    prm = _params(q, k, v, bias, pad, seed, dropout_prob, causal, scale, geom)
    prm.out, prm.lse = out.data_ptr(), lse.data_ptr()
    _launch({torch.bfloat16: "fwd_bf16", torch.float16: "fwd_fp16"}.get(
        q.dtype, "fwd"), prm, q.device)
    return out, lse


KEEP_PER_DIM = 4  # keys whose keep bits one output element carries


def kernel_keep_bits(q_shape, tk, dtype, bias, pad, seed, dropout_prob,
                     causal):
    """The forward kernel's keep mask at one call, read back exactly, to
    hold against :func:`keep_mask` on the card.  With q = k = 0 and a zero
    bias of ``bias``'s shape and type every admitted key scores 0, so
    p = 1 there and the output is the kept keys' v summed, scaled by the
    rounded 1 / keep_prob and divided by the admitted count.  v holds
    2^j for key 4 d + j of a window of 4 D keys (all the keys where there
    are fewer) in dim d, so each output element is an integer 0-15 that
    spells four keys' bits; the windows cover every key (the last one
    partly where 4 D does not divide ``tk``).  Returns ``(bits,
    admitted)``: the [B, H, Tq, Tk] bits read and the [B, 1, Tq, Tk]
    (query, key) pairs the pad and causal masks admit."""
    bsz, tq, heads, d = q_shape
    dev = pad.device
    zero_q = torch.zeros((bsz, tq, heads, d), dtype=dtype, device=dev)
    zero_k = torch.zeros((bsz, tk, heads, d), dtype=dtype, device=dev)
    bias0 = None if bias is None else torch.zeros_like(bias)
    geom = geometry(tq, tk, bias0)
    inv = torch.tensor(1.0 / (1.0 - dropout_prob), dtype=torch.float32)
    rate = float(inv if dtype == torch.float32 else inv.to(dtype))
    admitted = (pad == 0)[:, None, :].expand(bsz, tq, tk)
    if causal:
        rows = torch.arange(tq, device=dev)[:, None]
        admitted = admitted & (torch.arange(tk, device=dev)[None] <= rows)
    admitted_n = admitted.sum(-1)                               # [B, Tq]
    width = min(KEEP_PER_DIM * d, tk)
    bits = torch.zeros((bsz, heads, tq, tk), dtype=torch.bool, device=dev)
    for w in range(-(-tk // width)):
        n = min(width, tk - w * width)  # keys in this window
        keys = torch.arange(n, device=dev)
        v = torch.zeros((bsz, tk, heads, d), dtype=torch.float32,
                        device=dev)
        v[:, w * width + keys, :, keys // KEEP_PER_DIM] = (
            2.0 ** (keys % KEEP_PER_DIM)).float()[:, None, None]
        out, _ = flash_fwd_cuda(zero_q, zero_k, v.to(dtype), bias0, pad,
                                dropout_prob, seed, causal, d ** -0.5, geom)
        counts = out.float() * admitted_n[:, :, None, None] / rate
        near = counts.round()
        worst = float((counts - near).abs().max())
        if worst > 0.25:
            raise AssertionError(f"{dtype}: keep-bit read-back off an "
                                 f"integer by {worst}")
        near = near.to(torch.int64).permute(0, 2, 1, 3)   # [B, H, Tq, D]
        for j in range(KEEP_PER_DIM):
            cols = bits[..., w * width + j:w * width + n:KEEP_PER_DIM]
            cols[...] = ((near[..., :cols.shape[-1]] >> j) & 1).bool()
    return bits, admitted[:, None]


def flash_bwd_cuda(q, k, v, bias, pad, dropout_prob, seed, causal, scale,
                   geom, lse, delta, dout, want_dbias):
    """Launch the backward kernels: ``(dq, dk, dv, dbias_full)`` as
    :func:`flash_bwd_plain`.  bf16 and fp16 operands take the two
    tensor-core kernels of their type (dk/dv; dq with the per-group dbias
    partials, summed here), fp32 ones the three fp32 kernels (dk/dv, dq,
    and dbias when asked)."""
    _check(q, k, v, bias, pad, seed, causal)
    q, k, v, bias, pad, seed = _operands(q, k, v, bias, pad, seed)
    dout = _last_dim_unit(dout.to(q.dtype))
    lse, delta = lse.contiguous(), delta.contiguous()
    tc = q.dtype in _TENSOR_CORE
    if tc:
        q, k, v, bias, pad, dout = _tiles_aligned(q, k, v, bias, pad, dout)
        lse, delta = build.aligned16(lse), build.aligned16(delta)
    bsz, tq, heads, d = q.shape
    tk = k.shape[1]
    dq = torch.empty((bsz, tq, heads, d), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    prm = _params(q, k, v, bias, pad, seed, dropout_prob, causal, scale, geom)
    prm.lse, prm.delta, prm.dout = (lse.data_ptr(), delta.data_ptr(),
                                    dout.data_ptr())
    prm.sd_b, prm.sd_t, prm.sd_h = dout.stride()[:3]
    prm.dq, prm.dk, prm.dv = dq.data_ptr(), dk.data_ptr(), dv.data_ptr()
    if tc:
        prm.groups = pick_groups(bsz, tq, heads, d, want_dbias)
        parts = None
        if want_dbias:
            parts = torch.empty((prm.groups, heads, tq, tk),
                                dtype=torch.float32, device=q.device)
            prm.dbias = parts.data_ptr()
        suffix = _TENSOR_CORE[q.dtype]
        _launch("bwd_dkdv" + suffix, prm, q.device)
        _launch("bwd_dq" + suffix, prm, q.device)
        return dq, dk, dv, None if parts is None else sum_partials(parts)
    _launch("dkdv", prm, q.device)
    _launch("dq", prm, q.device)
    dbias = None
    if want_dbias:
        dbias = torch.empty((heads, tq, tk), dtype=torch.float32,
                            device=q.device)
        prm.dbias = dbias.data_ptr()
        _launch("dbias", prm, q.device)
    return dq, dk, dv, dbias


# -------------------------------------------------------------- autograd --

def _on(x, plain, cuda):
    if x.device.type == "cpu":
        return plain
    if x.device.type == "cuda":
        return cuda
    raise ValueError(f"flash attention has no path for {x.device}")


def _reduce_dbias(dbias_full, bias):
    """Batch-summed [H, Tq, Tk] -> the bias's broadcast shape, in its
    dtype (the reference's ``_reduce_dbias``)."""
    _, bH, bQ, _ = bias.shape
    db = dbias_full[None]
    if bH == 1:
        db = db.sum(dim=1, keepdim=True)
    if bQ == 1:
        db = db.sum(dim=2, keepdim=True)
    return db.to(bias.dtype)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, pad, dropout_prob, seed, causal, scale):
        geom = geometry(q.shape[1], k.shape[1], bias)
        fwd = _on(q, flash_fwd_plain, flash_fwd_cuda)
        out, lse = fwd(q, k, v, bias, pad, dropout_prob, seed, causal, scale,
                       geom)
        ctx.save_for_backward(q, k, v, bias, pad, seed, out, lse)
        ctx.args = (dropout_prob, causal, scale, geom)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, pad, seed, out, lse = ctx.saved_tensors
        dropout_prob, causal, scale, geom = ctx.args
        # delta = rowsum(dO * O), outside the kernels as in the reference
        delta = (dout.float() * out.float()).sum(dim=-1).transpose(1, 2)
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        bwd = _on(q, flash_bwd_plain, flash_bwd_cuda)
        dq, dk, dv, dbias_full = bwd(
            q, k, v, bias, pad, dropout_prob, seed, causal, scale, geom, lse,
            delta, dout, want_dbias)
        dbias = _reduce_dbias(dbias_full, bias) if want_dbias else None
        return dq, dk, dv, dbias, None, None, None, None, None


def flash(q, k, v, bias, pad, dropout_prob, seed, causal, scale):
    """The reference's ``_flash`` with the module layout: q/k/v [B, T, H,
    D], bias [1, 1|H, 1|Tq, Tk] or None, pad [B, Tk] int (>0 = pad) or
    None, per-row dropout seeds ``seed`` [B] int32 given explicitly."""
    return _Flash.apply(q, k, v, bias, pad, float(dropout_prob), seed,
                        bool(causal), float(scale))


def row_seeds(generator, bsz, device):
    """Per-row dropout seeds as the reference derives them: a base seed
    in [0, 2^31 - 1) drawn from ``generator``, plus ``row * -1640531527``
    with int32 wrap.  Drawn and computed on the generator's device, so a
    CUDA generator never syncs with the host."""
    base = torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=generator.device, dtype=torch.int64)
    rows = torch.arange(bsz, device=generator.device, dtype=torch.int64)
    seed = (base + rows * -1640531527 + 2 ** 31) % 2 ** 32 - 2 ** 31
    return seed.to(device=device, dtype=torch.int32)


def flash_attention(q, k, v, bias=None, key_padding_mask=None, causal=False,
                    dropout_prob=0.0, generator=None, is_training=True,
                    scale=None):
    """Blockwise attention.  q/k/v: [B, T, H, D]; ``bias`` broadcastable
    to [1, H, Tq, Tk] (batch-broadcast); ``key_padding_mask`` [B, Tk],
    nonzero = pad.  Returns [B, Tq, H, D].  Dropout draws its per-row
    seeds from ``generator`` (a ``torch.Generator``, required when
    dropout is on)."""
    bsz, tq, _, d = q.shape
    if causal and tq != k.shape[1]:
        raise ValueError(f"flash_attention(causal=True) requires tq == tk, "
                         f"got {tq} != {k.shape[1]}")
    if scale is None:
        scale = d ** -0.5
    if bias is not None and bias.dim() < 4:
        bias = bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape))
    p = float(dropout_prob) if is_training else 0.0
    if p > 0.0:
        if generator is None:
            raise ValueError("flash_attention: generator required for "
                             "dropout")
        seed = row_seeds(generator, bsz, q.device)
    else:
        seed = torch.zeros((bsz,), dtype=torch.int32, device=q.device)
    pad = None
    if key_padding_mask is not None:
        pad = key_padding_mask.to(torch.int32)
    return flash(q, k, v, bias, pad, p, seed, causal, scale)
