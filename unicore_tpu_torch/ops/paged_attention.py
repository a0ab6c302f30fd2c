"""Ragged paged attention: the CUDA kernel's wrapper and its plain version.

Replaces the Pallas TPU kernel ``unicore_tpu/ops/pallas/paged_attention.py``
(``_kernel``, reached through ``ragged_paged_attention``; the T == 1
``ragged_decode_attention`` is the same call).  The kernel is
``unicore_tpu_torch/csrc/paged_attention.cu``.

Bound on the card: memory.  A call must read, once, the K and V columns
of each row that some query admits — ``sum_b min(len_b, max_t pos_bt + 1)
* H * D * 4 * 2`` bytes — plus q, out and the index arrays, over the
H100's 3.35 TB/s; its arithmetic (two fp32 dot products per admitted
column) is far below the fp32 rate.  The kernel splits each row's
columns across blocks (:func:`split_plan`), stages K and V by 16-byte
``cp.async``, and merges the splits' partials in split order in the same
launch (:func:`combine_partials` is that merge in plain PyTorch).

Dispatch is by the tensor's device: a CPU tensor takes the plain version
(the tests' path), a CUDA tensor launches the kernel or raises.  There is
no fallback from the kernel to the plain version.
"""

import ctypes
import functools

import torch

from . import build

NEG = -1e30  # finite mask fill: a fully masked row stays NaN-free
MAX_HEAD_DIM = 256
_F32, _I32 = torch.float32, torch.int32

# The split plan: at most 8 splits a row, none shorter than 128 columns,
# each a multiple of 64 (every tile of the kernel divides it), and no more
# than it takes to plan about 8 blocks for each of the H100's 132 SMs —
# rows are ragged, so about half the planned blocks find columns.
MAX_SPLITS = 8
MIN_SPLIT_COLS = 128
SPLIT_ALIGN = 64
WANT_BLOCKS = 8 * 132


def gather_slots(pages, page_table, page_size):
    """[num_slots, H, D] pool + [B, P] tables -> [B, P*page_size, H, D]
    position-ordered per-sequence views."""
    bsz, npages = page_table.shape
    offs = torch.arange(page_size, device=page_table.device,
                        dtype=torch.long)
    flat = page_table.long()[:, :, None] * page_size + offs[None, None, :]
    return pages[flat.reshape(bsz, npages * page_size)]


def _scores(q, k_pages, v_pages, page_table, positions, lengths,
            page_size, scale):
    """``(s [B, H, T, S], admitted [B, 1, T, S], v [B, S, H, D])`` in
    fp32 over the table's ``S = P * page_size`` columns."""
    k = gather_slots(k_pages, page_table, page_size).float()  # [B,S,H,D]
    v = gather_slots(v_pages, page_table, page_size).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k)
    cols = torch.arange(k.shape[1], device=q.device)
    admitted = ((cols[None, None, :] <= positions[:, :, None].long())
                & (cols[None, None, :] < lengths[:, None, None].long()))
    return s, admitted[:, None], v


def paged_attention_plain(q, k_pages, v_pages, page_table, positions,
                          lengths, page_size, scale):
    """Gather + matmul + fp32 softmax: the kernel's function in plain
    PyTorch.  Column ``c`` of row ``b`` is admitted for query ``t`` iff
    ``c <= positions[b, t]`` and ``c < lengths[b]``; a query with no
    admitted column (position -1, or a row of length 0) comes out 0, as
    the kernel's does, so the two agree at every position."""
    s, admitted, v = _scores(q, k_pages, v_pages, page_table, positions,
                             lengths, page_size, scale)
    s = s.masked_fill(~admitted, NEG)
    p = torch.softmax(s, dim=-1) * admitted
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def split_plan(batch, heads, columns):
    """``(splits, split_cols)``: the kernel cuts each row's ``columns``
    (the table's ``P * page_size``) into ``splits`` ranges of
    ``split_cols``, the last one possibly short, none wholly past the
    table.  Host-known shapes alone decide it, so no launch waits on
    ``lengths`` or ``positions``, which live on the card."""
    if columns <= 0:
        return 1, SPLIT_ALIGN
    want = -(-WANT_BLOCKS // max(1, batch * heads))
    splits = max(1, min(MAX_SPLITS, want, -(-columns // MIN_SPLIT_COLS)))
    per = -(-columns // splits)
    per = -(-per // SPLIT_ALIGN) * SPLIT_ALIGN
    return -(-columns // per), per


def combine_partials(m, l, acc):
    """Merge per-split partials as the kernel does: ``m``, ``l``
    ``[splits, ..., 1]`` and ``acc`` ``[splits, ..., D]`` (unnormalized)
    -> ``sum_s w_s acc_s / sum_s w_s l_s`` with ``w_s = exp(m_s - M)``,
    ``M`` the max over live splits.  A split with no admitted column for
    a query (``l == 0``) gets weight 0 explicitly and its ``acc`` is
    never read: ``exp(m - M)`` is 1 when both are -1e30."""
    live = l > 0
    m_all = torch.where(live, m, -torch.inf).amax(dim=0)
    m_all = torch.where(torch.isfinite(m_all), m_all, 0.0)
    w = torch.where(live, torch.exp(m - m_all), 0.0)
    num = torch.where(live, w * acc, 0.0).sum(dim=0)
    return num / (w * l).sum(dim=0).clamp_min(1e-30)


def paged_attention_split_plain(q, k_pages, v_pages, page_table, positions,
                                lengths, page_size, scale, plan):
    """The kernel's split math in plain PyTorch (the tests' oracle of
    it): each split of ``plan = (splits, split_cols)`` computes the
    attention partial (m, l, unnormalized acc) of its column range,
    :func:`combine_partials` merges them.  The partial of a (split,
    query) with no admitted column is unspecified — the kernel never
    writes a split past a row's last admitted column — so it is NaN
    here, and the merge must leave it out."""
    splits, per = plan
    s, admitted, v = _scores(q, k_pages, v_pages, page_table, positions,
                             lengths, page_size, scale)
    ms, ls, accs = [], [], []
    for i in range(splits):
        part = slice(i * per, (i + 1) * per)
        a = admitted[..., part]
        si = s[..., part].masked_fill(~a, NEG)
        m = si.amax(dim=-1, keepdim=True)
        p = torch.where(a, torch.exp(si - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("bhqk,bkhd->bhqd", p, v[:, part])
        ms.append(m)
        ls.append(l)
        accs.append(torch.where(l > 0, acc, torch.nan))
    out = combine_partials(torch.stack(ms), torch.stack(ls),
                           torch.stack(accs))
    return out.transpose(1, 2).to(q.dtype)  # [B, T, H, D]


def _check(q, k_pages, v_pages, page_table, positions, lengths, page_size):
    """Raise unless the operands fit the kernel.  It runs at every launch
    (12 per ragged step), so each test is one cheap comparison and the
    messages are built only on a failure."""
    bsz, t, heads, d = q.shape
    floats = (q, k_pages, v_pages)
    ints = (page_table, positions, lengths)
    if (q.dtype is not _F32 or k_pages.dtype is not _F32
            or v_pages.dtype is not _F32):
        raise TypeError("q, k_pages, v_pages must be float32, got "
                        f"{[x.dtype for x in floats]}")
    if (page_table.dtype is not _I32 or positions.dtype is not _I32
            or lengths.dtype is not _I32):
        raise TypeError("page_table, positions, lengths must be int32, got "
                        f"{[x.dtype for x in ints]}")
    dev = q.get_device()
    for x in floats + ints:
        if x.get_device() != dev:
            raise ValueError(
                f"all operands must be on {q.device}, got one on {x.device}")
        if not x.is_contiguous():
            raise ValueError("paged attention operands must be contiguous")
    kshape = k_pages.shape
    if (v_pages.shape != kshape or len(kshape) != 3 or kshape[1] != heads
            or kshape[2] != d):
        raise ValueError(
            f"pools {tuple(kshape)}/{tuple(v_pages.shape)} do not "
            f"match q heads/head_dim ({heads}, {d})")
    if kshape[0] % page_size:
        raise ValueError(f"pool of {kshape[0]} slots is not a whole "
                         f"number of {page_size}-slot pages")
    tshape, pshape, lshape = page_table.shape, positions.shape, lengths.shape
    if (len(tshape) != 2 or tshape[0] != bsz or len(pshape) != 2
            or pshape[0] != bsz or pshape[1] != t or len(lshape) != 1
            or lshape[0] != bsz):
        raise ValueError(
            f"index shapes page_table {tuple(tshape)}, positions "
            f"{tuple(pshape)}, lengths {tuple(lshape)} do "
            f"not fit q {tuple(q.shape)}")
    if d % 4 or d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} unsupported by the kernel "
                         f"(a multiple of 4, at most {MAX_HEAD_DIM})")
    if (q.data_ptr() | k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        raise ValueError("q, k_pages and v_pages must be 16-byte aligned")


@functools.cache
def _kernel():
    """The kernel's C entry point, loaded (and built) once per process,
    with its ctypes signature set once."""
    fn = build.load("paged_attention").unicore_paged_attention_f32
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


# device index -> int32 ticket counters, zeroed once; the kernel's last
# split of each (row, head) resets its counter, so no call clears them.
# Two calls on one device must not run at once on two streams: they
# would share the counters.
_tickets = {}


def _ticket_buffer(device, n):
    buf = _tickets.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=_I32, device=device)
        _tickets[device.index] = buf
    return buf


def _launch(q, k_pages, v_pages, page_table, positions, lengths, page_size,
            scale):
    fn = _kernel()
    bsz, t, heads, d = q.shape
    npages = page_table.shape[1]
    splits, per = split_plan(bsz, heads, npages * page_size)
    out = torch.empty_like(q)
    ws = tickets = None
    if splits > 1:
        ws = torch.empty(bsz * heads * splits * t * (d + 2), dtype=_F32,
                         device=q.device)
        tickets = _ticket_buffer(q.device, bsz * heads)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 page_table.data_ptr(), positions.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(),
                 ws.data_ptr() if ws is not None else None,
                 tickets.data_ptr() if tickets is not None else None,
                 bsz, t, heads, d, npages, int(page_size), splits, per,
                 float(scale), stream)
    if err:
        raise build.KernelError(
            f"paged attention kernel launch failed: CUDA error {err}")
    return out


def ragged_paged_attention(q, k_pages, v_pages, page_table, positions,
                           lengths, *, page_size, scale):
    """Mixed prefill+decode paged attention: q [B, T, H, D], flat pools
    [num_slots, H, D], page_table [B, P] int32 (rows padded with page
    0), positions [B, T] int32 global positions (-1 = inactive query),
    lengths [B] int32 valid token count incl. this step's (0 = inactive
    row).  Returns [B, T, H, D].

    A CPU tensor takes :func:`paged_attention_plain`; a CUDA tensor
    launches the kernel (float32 only) and adds one to
    ``ragged_paged_attention.launches``."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     positions, lengths, page_size, scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention has no path for {q.device}")
    _check(q, k_pages, v_pages, page_table, positions, lengths, page_size)
    out = _launch(q, k_pages, v_pages, page_table, positions, lengths,
                  page_size, scale)
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
