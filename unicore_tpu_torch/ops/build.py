"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``unicore_tpu_torch/csrc/`` compiles on its own into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds): a ``.cu`` source for ``sm_90a`` with ``nvcc``, a ``.c``
source (the data tier's record reader) with the host C compiler
(``$CC``, else ``cc``, ``gcc`` or ``clang``).  Builds happen at first
use, never at import — the package imports on machines without
``nvcc`` — and land in
``build/unicore_tpu_torch/`` at the repository root, named by a digest
of the source and of every ``csrc/`` header it includes, so an edited
kernel or header never loads a stale library.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "unicore_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CC_FLAGS = ("-O2", "-std=c11", "-shared", "-fPIC")

# name -> loaded library, for this process; data-worker threads may ask
# for one together
_loaded = {}
_load_lock = threading.Lock()


class KernelError(RuntimeError):
    """A kernel could not be built, loaded or launched.  Never a
    per-request fault: callers let it propagate."""


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
        "kernels of unicore_tpu_torch are compiled at first use"
    )


def _cc():
    for cand in (os.environ.get("CC"), "cc", "gcc", "clang"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise KernelError(
        "no host C compiler ($CC, cc, gcc or clang on PATH): the record "
        "reader of unicore_tpu_torch is compiled at first use"
    )


def source(name):
    """``csrc/<name>.cu``, or ``csrc/<name>.c`` for a host library."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.c"


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name):
    """:func:`source` of ``name`` and every header of ``csrc/`` it
    includes, directly or through another header, in the order first
    reached."""
    todo, seen = [source(name)], []
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            dep = CSRC / inc.decode()
            if dep.exists():
                todo.append(dep)
    return seen


def library_path(name):
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names):
    """Compile every named source that has no up-to-date library, one
    compiler process per source, all started together.  Returns
    ``{name: {"seconds": wall, "log": ptxas report or "cached"}}``;
    raises :class:`KernelError` with the compiler's output on a
    failure."""
    procs, report = {}, {}
    todo = [n for n in names if not library_path(n).exists()]
    report.update({n: {"seconds": 0.0, "log": "cached"}
                   for n in names if n not in todo})
    if not todo:
        return report
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        src = source(name)
        if src.suffix == ".c":
            cmd = [_cc(), *CC_FLAGS, "-o", str(tmp), str(src)]
        else:
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: {Path(proc.args[0]).name} exited "
                          f"{proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if failed:
        raise KernelError("kernel build failed:\n" + "\n".join(failed))
    return report


def aligned16(x, strided=False):
    """``x`` as the kernels' 16-byte copies read it: its address, and
    with ``strided`` the strides of every dim but the last, multiples of
    16 bytes; a tensor that is not gets a contiguous copy."""
    step = 16 // x.element_size()
    if x.data_ptr() % 16 == 0 and (not strided or all(
            s % step == 0 for s in x.stride()[:-1])):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def load(name):
    """The ctypes library of kernel ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
