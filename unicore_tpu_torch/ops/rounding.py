"""fp32 -> bf16 stochastic rounding: the CUDA kernel's wrapper and its
plain version.

Replaces the Pallas TPU kernel of ``unicore_tpu/ops/pallas/rounding.py``
(``_kernel``, behind ``fp32_to_bf16_sr``): 16 random bits are added below
the bf16 mantissa boundary of each fp32 value, which is then truncated to
bf16; NaN and ±Inf pass through.  The kernel is
``unicore_tpu_torch/csrc/rounding.cu``, its noise the counter hash of
``csrc/prng.cuh``, bit for bit the TPU kernel's: the reference's
``[rows, 1024]`` layout of :func:`pick_layout` gives element i the seed
``seed + (i // 1024) // r_blk`` at index ``((i // 1024) % r_blk)·1024 +
i % 1024``.

Bound on the card: bytes (4 read and 2 written per element).  One
launch rounds a table of tensors (:func:`fp32_to_bf16_sr_multi`, up to
the kernel's capacity of entries a launch), each element with the bits
the reference's kernel gives it within its own tensor under that
tensor's seed: the optimizer rounds every parameter leaf in one or two
launches.  A single tensor is a table of one.

An entry may be a slice of a larger leaf, as a ZeRO-1 rank holds it
(``window=(leaf_numel, origin, span, stride)``): slice element i is leaf
element ``(i // span)·stride + origin + i % span`` and draws that
element's bits, the leaf's layout (``pick_layout(leaf_numel)``) and seed
throughout, so the slices of a leaf round exactly as the whole leaf does.

The JAX function draws its int32 seed from a key; these take the seeds
(int32 tensors, read on the card, or an int), which a caller draws from
its ``torch.Generator``.  Dispatch is by device: a CPU tensor takes the
plain version, a CUDA tensor launches the kernel or raises
:class:`~unicore_tpu_torch.ops.build.KernelError`.
"""

import ctypes
import functools

import torch

from . import build, prng

LANE = 1024
SUBLANE = 8

# launches of the kernel, counted where the wrapper launches it
launches = {"fp32_to_bf16_sr": 0}


class _Entry(ctypes.Structure):
    """``SrEntry`` of the CUDA source, field for field."""
    _fields_ = [("x", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("n", ctypes.c_int), ("first_block", ctypes.c_int),
                ("origin", ctypes.c_int), ("span", ctypes.c_int),
                ("stride", ctypes.c_int), ("seed", ctypes.c_short),
                ("r_blk", ctypes.c_short)]


def pick_layout(n):
    """The reference's ``(rows, r_blk)`` for an n-element array: rows of
    1024 padded to a multiple of 8, blocks of 256 rows when that divides
    them, else of 8 (a copy of its ``pick_layout``)."""
    rows = -(-n // LANE)
    rows = -(-rows // SUBLANE) * SUBLANE
    r_blk = 256 if rows % 256 == 0 else SUBLANE
    return rows, r_blk


def whole(n):
    """The window of an n-element tensor that is a leaf of its own."""
    return (n, 0, max(n, 1), max(n, 1))


def leaf_index(i, window):
    """Slice element indices ``i`` -> their indices in the leaf."""
    _, origin, span, stride = window
    return (i // span) * stride + origin + i % span


def fp32_to_bf16_sr_plain(x, seed, window=None):
    """The kernel's function in plain PyTorch: bf16 of x's shape; with
    ``window``, x is that slice of a larger leaf."""
    x32 = x.float().reshape(-1)
    n = x32.numel()
    window = window or whole(n)
    _, r_blk = pick_layout(window[0])
    i = leaf_index(torch.arange(n, dtype=torch.int64, device=x.device),
                   window)
    row = i // LANE
    noise = prng.random_bits(
        torch.as_tensor(seed, device=x.device).reshape(()).long()
        + row // r_blk, (row % r_blk) * LANE + i % LANE) & 0xFFFF
    bits = x32.view(torch.int32).long() & prng.MASK32
    rounded = torch.where(torch.isfinite(x32), (bits + noise) & prng.MASK32,
                          bits)
    hi = rounded >> 16
    nan = ((hi & 0x7F80) == 0x7F80) & ((hi & 0x7F) != 0)
    hi = torch.where(nan, (hi & 0x8000) | 0x7FC0, hi)
    hi = hi - (hi >= 0x8000).long() * 0x10000  # as a signed 16-bit value
    return hi.to(torch.int16).view(torch.bfloat16).reshape(x.shape)


def fp32_to_bf16_sr_multi_plain(xs, seeds, outs, windows=None):
    """The table kernel's function in plain PyTorch: ``outs[i]`` gets
    :func:`fp32_to_bf16_sr_plain` of ``xs[i]`` under ``seeds[i]`` (seeds
    flattened) and ``windows[i]``.  Returns ``outs``."""
    seeds = torch.as_tensor(seeds).reshape(-1)
    windows = windows or [None] * len(xs)
    for i, (x, out) in enumerate(zip(xs, outs)):
        out.copy_(fp32_to_bf16_sr_plain(x, seeds[i], windows[i])
                  .reshape(out.shape))
    return outs


@functools.cache
def _library():
    lib = build.load("rounding")
    lib.unicore_fp32_to_bf16_sr.restype = ctypes.c_int
    lib.unicore_fp32_to_bf16_sr.argtypes = [
        ctypes.POINTER(_Entry), ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    lib.unicore_fp32_to_bf16_sr_capacity.restype = ctypes.c_int
    return lib


def capacity():
    """The most entries one launch of the kernel takes."""
    return _library().unicore_fp32_to_bf16_sr_capacity()


def fp32_to_bf16_sr_multi_cuda(xs, seeds, outs, windows=None):
    """Launch the kernel over every (``xs[i]``, ``outs[i]``) pair: fp32
    inputs (a contiguous fp32 copy of one that is not), contiguous bf16
    outputs of the same sizes, ``seeds`` an int32 tensor with one seed
    per pair and ``windows[i]`` (None: a whole leaf), all on one card.
    One launch per :func:`capacity` entries; empty tensors take none."""
    if len(xs) != len(outs) or seeds.numel() != len(xs):
        raise ValueError(f"{len(xs)} inputs, {len(outs)} outputs and "
                         f"{seeds.numel()} seeds do not pair up")
    device = seeds.device
    if seeds.dtype != torch.int32 or device.type != "cuda":
        raise ValueError(f"seeds must be int32 on the card, got "
                         f"{seeds.dtype} on {device}")
    seeds = seeds.contiguous()
    windows = windows or [None] * len(xs)
    entries, keep = [], []  # (seed index, fields, r_blk) per entry
    for i, (x, out) in enumerate(zip(xs, outs)):
        x = x.float().contiguous()
        if (out.dtype != torch.bfloat16 or out.numel() != x.numel()
                or not out.is_contiguous() or out.device != device
                or x.device != device):
            raise ValueError(f"entry {i}: out must be a contiguous bf16 "
                             f"tensor of x's size, both on {device}")
        if x.numel():
            leaf, origin, span, stride = windows[i] or whole(x.numel())
            if leaf >= 2 ** 31:
                raise ValueError(f"entry {i}: a leaf of {leaf} elements; "
                                 "the kernel indexes leaves below 2^31")
            keep.append(x)  # alive until the launch
            entries.append((i, (x.data_ptr(), out.data_ptr(), x.numel(), 0,
                                origin, span, stride), pick_layout(leaf)[1]))
    lib, step = _library(), capacity()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for s in range(0, len(entries), step):
            chunk = entries[s:s + step]
            # the chunk's seeds from its first entry's on: each entry's
            # index into them fits the kernel's 16 bits
            base = chunk[0][0]
            if chunk[-1][0] - base >= 2 ** 15:
                raise ValueError("more than 32,767 empty tensors between "
                                 "two rounded ones")
            table = (_Entry * len(chunk))(*(
                _Entry(*fields, i - base, r_blk)
                for i, fields, r_blk in chunk))
            err = lib.unicore_fp32_to_bf16_sr(
                table, len(chunk), seeds.data_ptr() + 4 * base, stream)
            if err:
                raise build.KernelError(
                    f"fp32_to_bf16_sr kernel launch failed: CUDA error {err}")
            launches["fp32_to_bf16_sr"] += 1
    return outs


def fp32_to_bf16_sr_multi(xs, seeds, outs, windows=None):
    """Stochastically rounded bf16 of every tensor of ``xs`` into the
    matching tensor of ``outs`` (bf16, same sizes), ``xs[i]`` under
    ``seeds[i]`` of the int32 tensor ``seeds`` (flattened), as the slice
    ``windows[i]`` of its leaf where ``windows`` gives one; one launch
    for all of them on the card.  Returns ``outs``."""
    if not xs:
        return outs
    device = xs[0].device
    if device.type == "cpu":
        return fp32_to_bf16_sr_multi_plain(xs, seeds, outs, windows)
    if device.type != "cuda":
        raise ValueError(f"fp32_to_bf16_sr has no path for {device}")
    return fp32_to_bf16_sr_multi_cuda(xs, seeds.reshape(-1), outs, windows)


def fp32_to_bf16_sr_cuda(x, seed, out=None):
    """The kernel on one tensor (a table of one): fp32 ``x`` and a
    one-element int32 ``seed`` on x's card; writes ``out`` (a contiguous
    bf16 tensor of x's size) when given."""
    seed = seed.reshape(-1)
    if seed.numel() != 1 or seed.device != x.device:
        raise ValueError(f"seed must be one int32 on {x.device}, got "
                         f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
    if out is None:
        out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    fp32_to_bf16_sr_multi_cuda([x], seed, [out])
    return out


def fp32_to_bf16_sr(x, seed, out=None):
    """Stochastically rounded bf16 of ``x`` under the int32 ``seed``
    (a one-element tensor or an int).  With ``out`` (bf16, x's size), the
    result is written there and returned."""
    if x.device.type == "cpu":
        result = fp32_to_bf16_sr_plain(x, seed)
        if out is None:
            return result
        return out.copy_(result.reshape(out.shape))
    if x.device.type != "cuda":
        raise ValueError(f"fp32_to_bf16_sr has no path for {x.device}")
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor([seed], dtype=torch.int32)
    return fp32_to_bf16_sr_cuda(x, seed.to(x.device), out)
