"""Helpers shared by the port's modules (the subset of
``unicore_tpu/utils.py`` the serve slice needs)."""

import torch
import torch.nn.functional as F


def get_activation_fn(activation):
    """Activation by name.  ``"gelu"`` is the exact (erf) form, as in
    the JAX package (``jax.nn.gelu(approximate=False)``)."""
    fns = {
        "gelu": F.gelu,
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
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
