"""EMA of the fp32 master parameters: the CUDA kernel's wrapper and its
plain version.

The JAX trainer updates its EMA inside the jitted step (no Pallas
kernel): ``ema * d + p * (1.0 - d)`` with ``d = jnp.float32(ema_decay)``,
so ``1 - d`` is formed in fp32 (0.00099998713 for 0.999, not the 0.001
of a Python ``1 - 0.999``), and XLA contracts the expression to
``fma(ema, d, p * (1 - d))``: ``p * (1 - d)`` rounds to fp32, then
``ema * d`` is added to it with one rounding.  Both versions here give
those bits:

- the kernel (``csrc/ema.cu``) with ``fmaf``, every leaf of a table in
  one launch (bound by bytes: 8 read and 4 written per element);
- the plain version through float64, where ``ema * d`` is exact and the
  sum rounds once; where that rounding lands on an fp32 tie it is
  corrected by the sum's exact error (TwoSum), so the result is the
  single-rounding ``fma`` and not a double rounding.

Dispatch is by device: CPU tensors take the plain version, CUDA tensors
launch the kernel or raise :class:`~unicore_tpu_torch.ops.build.KernelError`.
The update is in place.
"""

import ctypes
import functools

import numpy as np
import torch

from . import build
from ..utils import fma_fp32

# launches of the kernel, counted where the wrapper launches it
launches = {"ema_update": 0}


class _Entry(ctypes.Structure):
    """``EmaEntry`` of the CUDA source, field for field."""
    _fields_ = [("ema", ctypes.c_void_p), ("p", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("first_block", ctypes.c_longlong)]


def decay_terms(decay):
    """``(d, 1 - d)`` as the JAX trainer forms them: both fp32."""
    d = np.float32(decay)
    return d, np.float32(1.0) - d


@torch.no_grad()
def ema_update_plain(emas, params, decay):
    """The kernel's function in plain PyTorch, in place on ``emas``."""
    d, omd = decay_terms(decay)
    for e, p in zip(emas, params):
        e.copy_(fma_fp32(e, d, p * float(omd)))
    return emas


@functools.cache
def _library():
    lib = build.load("ema")
    lib.unicore_ema_update.restype = ctypes.c_int
    lib.unicore_ema_update.argtypes = [
        ctypes.POINTER(_Entry), ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p]
    lib.unicore_ema_update_capacity.restype = ctypes.c_int
    return lib


def capacity():
    """The most entries one launch of the kernel takes."""
    return _library().unicore_ema_update_capacity()


def ema_update_cuda(emas, params, decay):
    """Launch the kernel over every (``emas[i]``, ``params[i]``) pair:
    contiguous fp32 tensors of equal sizes on one card.  One launch per
    :func:`capacity` entries; empty tensors take none."""
    device = emas[0].device
    entries = []
    for i, (e, p) in enumerate(zip(emas, params)):
        if (e.dtype != torch.float32 or p.dtype != torch.float32
                or e.numel() != p.numel() or not e.is_contiguous()
                or not p.is_contiguous() or e.device != device
                or p.device != device):
            raise ValueError(f"entry {i}: ema and param must be contiguous "
                             f"fp32 tensors of one size on {device}")
        if e.numel():
            entries.append(_Entry(e.data_ptr(), p.data_ptr(), e.numel(), 0))
    d, omd = decay_terms(decay)
    lib, step = _library(), capacity()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for s in range(0, len(entries), step):
            chunk = entries[s:s + step]
            err = lib.unicore_ema_update((_Entry * len(chunk))(*chunk),
                                         len(chunk), float(d), float(omd),
                                         stream)
            if err:
                raise build.KernelError(
                    f"ema_update kernel launch failed: CUDA error {err}")
            launches["ema_update"] += 1
    return emas


def ema_update_(emas, params, decay):
    """``emas[i] = fma(emas[i], d, params[i] * (1 - d))`` in place, with
    ``d = float32(decay)`` and ``1 - d`` formed in fp32: the JAX
    trainer's update, bit for bit.  Returns ``emas``."""
    if len(emas) != len(params):
        raise ValueError(f"{len(emas)} EMA tensors for {len(params)} "
                         "parameters")
    if not emas:
        return emas
    device = emas[0].device
    if device.type == "cpu":
        return ema_update_plain(emas, params, decay)
    if device.type != "cuda":
        raise ValueError(f"ema_update has no path for {device}")
    return ema_update_cuda(emas, params, decay)
