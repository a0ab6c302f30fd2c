"""The record store's native reader: ``csrc/record_reader.c`` through
ctypes, whose foreign calls run with the GIL released, so thread data
workers overlap their disk reads.

The library builds at first use with the host C compiler
(``ops/build.py``) into ``build/unicore_tpu_torch/``, named by a digest
of its source; a failed build raises
:class:`~unicore_tpu_torch.ops.build.KernelError`, and nothing falls back
to the mmap path.  Loading batches inline (``--num-workers 0``) never
needs it.
"""

import ctypes
import os

import numpy as np

# read_spans' codes besides an errno (csrc/record_reader.c)
_BAD_SPAN, _SHORT_READ = -1, -2

_I64P = ctypes.POINTER(ctypes.c_int64)


def _lib():
    from ..ops import build

    lib = build.load("record_reader")
    if not getattr(lib, "typed", False):
        lib.rr_read_spans.argtypes = [ctypes.c_char_p, _I64P, _I64P,
                                   ctypes.c_int64, ctypes.c_void_p]
        lib.rr_read_spans.restype = ctypes.c_int
        lib.rr_readahead.argtypes = [ctypes.c_char_p, _I64P, _I64P,
                                  ctypes.c_int64]
        lib.rr_readahead.restype = ctypes.c_int64
        lib.typed = True
    return lib


def _spans(starts, lens):
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    if starts.shape != lens.shape or starts.ndim != 1:
        raise ValueError("starts/lengths length mismatch")
    return starts, lens


def read_spans(path, starts, lens):
    """The bytes of each span ``[start, start + len)`` of ``path``, one
    ``bytes`` object a span, read with ``pread`` and the GIL released."""
    starts, lens = _spans(starts, lens)
    buf = np.empty(max(int(lens.sum()), 1), dtype=np.uint8)
    rc = _lib().rr_read_spans(os.fsencode(path), starts.ctypes.data_as(_I64P),
                           lens.ctypes.data_as(_I64P), len(starts),
                           buf.ctypes.data)
    if rc == _BAD_SPAN:
        raise ValueError("negative span (corrupt offset index?)")
    if rc == _SHORT_READ:
        raise OSError(f"read_spans: short read (truncated file?) on {path}")
    if rc != 0:
        raise OSError(rc, os.strerror(rc), path)
    ends = np.cumsum(lens)
    raw = memoryview(buf)
    return [bytes(raw[e - n:e]) for e, n in zip(ends.tolist(), lens.tolist())]


def readahead(path, starts, lens):
    """Warm the page cache for these spans of ``path``
    (``posix_fadvise`` then a bounded ``pread`` sweep, the GIL released);
    returns the bytes touched."""
    starts, lens = _spans(starts, lens)
    got = _lib().rr_readahead(os.fsencode(path), starts.ctypes.data_as(_I64P),
                           lens.ctypes.data_as(_I64P), len(starts))
    if got < 0:
        raise OSError(-got, os.strerror(-got), path)
    return int(got)
