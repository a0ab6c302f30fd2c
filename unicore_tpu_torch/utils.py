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
def rounded_constant(value, dtype):
    """``value`` rounded to ``dtype``, as jax rounds a constant or a
    weakly typed Python scalar to the dtype of the array it meets.
    Multiplied into a tensor of that dtype it gives jax's product: torch
    forms it in fp32 from the exact operands and rounds once, as XLA
    does."""
    return torch.tensor(value, dtype=dtype).item()


def fma_fp32(x, y, z):
    """``x * y + z`` of fp32 tensors (``y`` may be an fp32 scalar) with
    one rounding, as an fp32 fused multiply-add gives it: the product is
    exact in float64, the sum rounds once there, and a result that lands
    on a tie between two fp32 values goes to the side of the sum's
    rounding error instead of to the even one."""
    a = x.double() * (float(y) if not torch.is_tensor(y) else y.double())
    b = z.double()
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)  # exact: s + err == a + b
    r = s.float()
    diff = s - r.double()
    toward = torch.full_like(r, float("inf")).copysign(diff.float())
    r2 = torch.nextafter(r, toward)  # the fp32 neighbour on s's side
    tie = (diff != 0) & (diff * 2 == r2.double() - r.double())
    return torch.where(tie & (err * diff > 0), r2, r)


class _Gelu(torch.autograd.Function):
    """``jax.nn.gelu(x, approximate=False)`` and the gradient JAX forms
    for it, op for op in x's dtype: each op rounds, so under bf16 and fp16
    both are flax's bit for bit (``F.gelu`` rounds once from fp32, and
    autograd's chain of the forward's ops rounds elsewhere than JAX's
    transposed JVP).  ``x * -c`` is jax's ``-x * c``: negation is
    exact."""

    @staticmethod
    def forward(ctx, x):
        d = x * -rounded_constant(math.sqrt(0.5), x.dtype)
        e = torch.erfc(d)
        ctx.save_for_backward(x, d, e)
        return 0.5 * x * e

    @staticmethod
    def backward(ctx, g):
        x, d, e = ctx.saved_tensors
        dt = x.dtype
        # erfc'(d) = -2/sqrt(pi) exp(-d^2), applied as JAX transposes it
        n = rounded_constant(-2 / math.sqrt(math.pi), dt) * ((0.5 * x) * g) \
            * torch.exp(-(d * d))
        return -(n * rounded_constant(math.sqrt(0.5), dt)) + 0.5 * (g * e)


class _GeluTanh(torch.autograd.Function):
    """``jax.nn.gelu(x, approximate=True)`` and JAX's gradient of it, op
    for op (``x ** 3`` is ``integer_pow``: two rounded products; its
    derivative ``3 * x ** 2``).  In fp16 ``x ** 3`` overflows above
    |x| ≈ 40.3 and the forward saturates to x (or -0) exactly as JAX's
    does; where ``3 * x ** 2`` overflows too (|x| > 147.8) JAX's gradient
    is 0 · inf = NaN, and so is this one."""

    @staticmethod
    def forward(ctx, x):
        cube = rounded_constant(0.044715, x.dtype) * (x * x * x)
        h = torch.tanh(rounded_constant(math.sqrt(2 / math.pi), x.dtype)
                       * (x + cube))
        ctx.save_for_backward(x, h)
        return x * (0.5 * (1.0 + h))

    @staticmethod
    def backward(ctx, g):
        x, h = ctx.saved_tensors
        dt = x.dtype
        o = (0.5 * (x * g)) * (1.0 - h)
        r = rounded_constant(math.sqrt(2 / math.pi), dt) * (o + o * h)
        s = g * (0.5 * (1.0 + h)) + r
        return s + (rounded_constant(0.044715, dt) * r) * (3.0 * (x * x))


def gelu(x):
    """``jax.nn.gelu(x, approximate=False)``, forward and gradient op for
    op (:class:`_Gelu`)."""
    return _Gelu.apply(x)


def gelu_tanh(x):
    """``jax.nn.gelu(x, approximate=True)``, forward and gradient op for
    op (:class:`_GeluTanh`)."""
    return _GeluTanh.apply(x)


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


def arg_bool(x):
    """Strict boolean argparse type (the JAX package's ``arg_bool``):
    unknown text raises instead of falling back."""
    import argparse

    if isinstance(x, bool):
        return x
    s = str(x).strip().lower()
    if s in ("true", "t", "yes", "y", "1"):
        return True
    if s in ("false", "f", "no", "n", "0"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {x!r}")


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
