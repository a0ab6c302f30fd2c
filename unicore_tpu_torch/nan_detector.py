"""NaN/Inf localization (counterpart of ``unicore_tpu/nan_detector.py``).

The JAX detector re-runs the forward with flax's ``capture_intermediates``
and lists every module whose output holds a non-finite value, by its
flax path: ``blocks_0/row_attn/q_proj/__call__/0`` (the module's first
call; a tuple output adds the element's index).  Here forward hooks on
every submodule collect the same outputs over one forward with dropout
off, and name them in the same layout — ``blocks.0.row_attn.q_proj``
becomes ``blocks_0/row_attn/q_proj``, the model itself the empty path —
so the two packages' logs can be compared line for line.  The hooks are
removed when the run ends, also when it raises.

:func:`find_nonfinite_leaves` lists the non-finite leaves of a nested
dict of arrays or tensors (the trainer passes the flax trees of its
params and its optimizer's state) by the same ``/``-joined paths, in the
JAX tree's order (keys sorted at every level).
"""

import logging
import re

import numpy as np
import torch

logger = logging.getLogger(__name__)


def flax_module_path(name):
    """A torch submodule name in the flax layout: a ``ModuleList`` index
    joins its list's name (``blocks.0`` -> ``blocks_0``), the other dots
    become ``/``."""
    return re.sub(r"\.(\d+)(?=\.|$)", r"_\1", name).replace(".", "/")


def _outputs(out):
    """(index path, tensor) of every floating tensor of a module output,
    flax's ``capture_intermediates`` indices: none for a tensor, one per
    element of a tuple."""
    if torch.is_tensor(out):
        return [((), out)]
    if isinstance(out, (tuple, list)):
        return [((i, *idx), t) for i, o in enumerate(out)
                for idx, t in _outputs(o)]
    return []


@torch.no_grad()
def find_nonfinite_modules(model, sample):
    """Run ``model(**sample["net_input"])`` in eval mode with a forward
    hook on every module; return ``(path, count)`` of each module output
    holding non-finite values, paths in the flax layout, in the JAX
    detector's (sorted-path) order."""
    calls, bad, handles = {}, [], []

    def hook(name):
        def record(module, args, out):
            k = calls[name] = calls.get(name, -1) + 1
            for idx, t in _outputs(out):
                if not t.is_floating_point():
                    continue
                n_bad = int((~torch.isfinite(t)).sum())
                if n_bad:
                    path = (*(flax_module_path(name).split("/")
                              if name else ()), "__call__", k, *idx)
                    bad.append((path, n_bad))
        return record

    was_training = model.training
    try:
        for name, module in model.named_modules():
            handles.append(module.register_forward_hook(hook(name)))
        model.eval()
        model(**sample["net_input"])
    finally:
        for h in handles:
            h.remove()
        model.train(was_training)
    bad.sort(key=lambda item: item[0])
    return [("/".join(map(str, path)), n) for path, n in bad]


def log_nonfinite_modules(model, sample):
    bad = find_nonfinite_modules(model, sample)
    if not bad:
        logger.warning(
            "NanDetector: forward re-run produced no non-finite intermediates "
            "(non-determinism or gradient-only NaN)")
    for name, n in bad:
        logger.warning("NanDetector: non-finite output in %s (%d values)",
                       name, n)
    return bad


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], (*prefix, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, (*prefix, f"[{i}]"))
    else:
        yield prefix, tree


def find_nonfinite_leaves(tree):
    """``(path, count)`` of each floating leaf of ``tree`` (nested dicts
    and lists of numpy arrays or tensors) that holds non-finite values.

    The state's counterpart of :func:`find_nonfinite_modules`: a poisoned
    leaf of the optimizer's state (a moment, a momentum buffer) under
    finite params is a failure a forward re-run cannot see."""
    bad = []
    for path, leaf in _flatten(tree):
        if torch.is_tensor(leaf):
            if not leaf.is_floating_point():
                continue
            n_bad = int((~torch.isfinite(leaf)).sum())
        else:
            arr = np.asarray(leaf)
            if not np.issubdtype(arr.dtype, np.floating):
                continue
            n_bad = int((~np.isfinite(arr)).sum())
        if n_bad:
            bad.append(("/".join(path), n_bad))
    return bad


def log_nonfinite_state(state, header="state"):
    bad = find_nonfinite_leaves(state)
    if not bad:
        logger.info("NanDetector: %s is clean (all leaves finite)", header)
    for name, n in bad:
        logger.warning("NanDetector: non-finite %s leaf %s (%d values)",
                       header, name, n)
    return bad
