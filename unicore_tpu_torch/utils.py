"""Helpers shared by the port's modules (the subset of
``unicore_tpu/utils.py`` the serve and training slices need)."""

import functools
import importlib
import math
import sys
from pathlib import Path

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def _rounded(value, dtype):
    """``value`` rounded to ``dtype``, as ``np.float64(value).astype``
    rounds jax's constants.  Multiplied into a tensor of that dtype it
    gives jax's product: torch forms it in fp32 from the exact operands
    and rounds once, as XLA does."""
    return torch.tensor(value, dtype=dtype).item()


def gelu(x):
    """``jax.nn.gelu(x, approximate=False)`` op for op: each op rounds to
    x's dtype, so under bf16 the result is flax's bit for bit (``F.gelu``
    rounds once from fp32).  ``x * -c`` is jax's ``-x * c``: negation is
    exact."""
    return 0.5 * x * torch.erfc(x * -_rounded(math.sqrt(0.5), x.dtype))


def gelu_tanh(x):
    """``jax.nn.gelu(x, approximate=True)`` op for op (``x ** 3`` is
    ``integer_pow``: two rounded products)."""
    cube = _rounded(0.044715, x.dtype) * (x * x * x)
    inner = _rounded(math.sqrt(2 / math.pi), x.dtype) * (x + cube)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def get_activation_fn(activation):
    """Activation by name.  ``"gelu"`` is the exact (erf) form, as in
    the JAX package (``jax.nn.gelu(approximate=False)``)."""
    fns = {
        "gelu": gelu,
        "gelu_tanh": gelu_tanh,
        "relu": F.relu,
        "tanh": torch.tanh,
        "silu": F.silu,
        "linear": lambda x: x,
    }
    if activation not in fns:
        raise RuntimeError(f"--activation-fn {activation} not supported")
    return fns[activation]


def causal_iota_mask(tq, tk, neg=-1e30, device=None):
    """Additive ``[tq, tk]`` causal mask, bottom-right aligned: query
    ``i`` attends keys ``<= i + tk - tq``.  ``neg`` is large but finite,
    so a fully masked softmax row stays NaN-free."""
    rows = torch.arange(tq, device=device)[:, None]
    cols = torch.arange(tk, device=device)[None, :]
    return torch.zeros(tq, tk, device=device).masked_fill(
        cols > rows + (tk - tq), neg)


def eval_bool(x, default=False):
    """Parse a boolean-ish CLI value by text matching (never ``eval``):
    ``"false"``/``"False"``/``"0"`` all mean False; unknown text falls
    back to ``default``."""
    if x is None:
        return default
    if isinstance(x, bool):
        return x
    s = str(x).strip().lower()
    if s in ("true", "t", "yes", "y", "1"):
        return True
    if s in ("false", "f", "no", "n", "0", ""):
        return False
    return default


def import_user_module(user_dir):
    """Import the ``--user-dir`` plugin so its registrations run.  A
    directory inside this package imports under its dotted name (so its
    relative imports resolve and it registers once); any other directory
    imports as a top-level module from its parent."""
    if user_dir is None:
        return
    path = Path(user_dir).resolve()
    if not path.exists():
        raise FileNotFoundError(str(path))
    pkg = Path(__file__).resolve().parent
    if path == pkg or pkg in path.parents:
        rel = path.relative_to(pkg.parent)
        importlib.import_module(".".join(rel.parts))
        return
    if path.name not in sys.modules:
        sys.path.insert(0, str(path.parent))
        try:
            importlib.import_module(path.name)
        finally:
            sys.path.pop(0)
