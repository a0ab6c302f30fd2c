"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``unicore_tpu_torch/csrc/`` compiles on its own into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), for ``sm_90a``.  Builds happen at first use, never at
import — the package imports on machines without ``nvcc`` — and land in
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
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "unicore_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# name -> loaded library, for this process
_loaded = {}


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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name):
    """``csrc/<name>.cu`` and every header of ``csrc/`` it includes,
    directly or through another header, in the order first reached."""
    todo, seen = [CSRC / f"{name}.cu"], []
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
    ``nvcc`` process per source, all started together.  Returns
    ``{name: {"seconds": wall, "log": ptxas report or "cached"}}``;
    raises :class:`KernelError` with the compiler's output on a
    failure."""
    procs, report = {}, {}
    todo = [n for n in names if not library_path(n).exists()]
    report.update({n: {"seconds": 0.0, "log": "cached"}
                   for n in names if n not in todo})
    if not todo:
        return report
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
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
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
