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

Bound on the card: bytes (4 read and 2 written per element).

The JAX function draws its int32 seed from a key; this one takes the
seed (a one-element int32 tensor, read on the card, or an int), which a
caller draws from its ``torch.Generator``.  Dispatch is by device: a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises :class:`~unicore_tpu_torch.ops.build.KernelError`.
"""

import ctypes
import functools

import torch

from . import build, prng

LANE = 1024
SUBLANE = 8

# launches of the kernel, counted where the wrapper launches it
launches = {"fp32_to_bf16_sr": 0}


def pick_layout(n):
    """The reference's ``(rows, r_blk)`` for an n-element array: rows of
    1024 padded to a multiple of 8, blocks of 256 rows when that divides
    them, else of 8 (a copy of its ``pick_layout``)."""
    rows = -(-n // LANE)
    rows = -(-rows // SUBLANE) * SUBLANE
    r_blk = 256 if rows % 256 == 0 else SUBLANE
    return rows, r_blk


def fp32_to_bf16_sr_plain(x, seed):
    """The kernel's function in plain PyTorch: bf16 of x's shape."""
    x32 = x.float().reshape(-1)
    n = x32.numel()
    _, r_blk = pick_layout(n)
    i = torch.arange(n, dtype=torch.int64, device=x.device)
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


@functools.cache
def _entry():
    fn = build.load("rounding").unicore_fp32_to_bf16_sr
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    return fn


def fp32_to_bf16_sr_cuda(x, seed, out=None):
    """Launch the kernel on fp32 ``x`` (a contiguous copy if it is not
    one) and a one-element int32 ``seed`` on x's card; writes ``out`` (a
    contiguous bf16 tensor of x's size) when given."""
    if x.dtype != torch.float32:
        x = x.float()
    x = x.contiguous()
    seed = seed.reshape(-1)
    if seed.dtype != torch.int32 or seed.numel() != 1 or \
            seed.device != x.device:
        raise ValueError(f"seed must be one int32 on {x.device}, got "
                         f"{seed.dtype} {tuple(seed.shape)} on {seed.device}")
    if out is None:
        out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    elif (out.dtype != torch.bfloat16 or out.numel() != x.numel()
          or not out.is_contiguous() or out.device != x.device):
        raise ValueError("out must be a contiguous bf16 tensor of x's size "
                         "on x's device")
    _, r_blk = pick_layout(x.numel())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _entry()(x.data_ptr(), out.data_ptr(), x.numel(),
                       seed.data_ptr(), r_blk, stream)
    if err:
        raise build.KernelError(
            f"fp32_to_bf16_sr kernel launch failed: CUDA error {err}")
    launches["fp32_to_bf16_sr"] += 1
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
