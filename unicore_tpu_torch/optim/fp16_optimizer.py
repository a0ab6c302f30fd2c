"""Mixed-precision casts of the port (counterpart of
``unicore_tpu/optim/fp16_optimizer.py``).

- :func:`sync_master_to_model` casts the fp32 master parameters into the
  bf16 or fp16 compute copy: round to nearest, or under ``--bf16-sr``
  stochastic rounding — one seed per leaf, drawn on the card, every leaf
  in one kernel launch.
  The JAX package applies the SR cast inside the differentiated loss
  with a straight-through gradient; the port casts the compute copy
  before the forward and folds the copy's gradients into the master
  gradients as identity (the trainer's ``_fold_compute_grads``), which
  is the same gradient.
- :func:`cast_moments` casts one fp32 optimizer-moment leaf to its store
  type: stochastic rounding for bf16 by default (an unbiased EMA), or
  round-to-nearest when asked for explicitly.
- :func:`grads_finite` and :func:`default_scale_window` serve ``--fp16``'s
  loss scaler (``dynamic_loss_scaler.py``).
"""

import torch

from ..ops.prng import draw_seeds
from ..ops.rounding import fp32_to_bf16_sr, fp32_to_bf16_sr_multi


@torch.no_grad()
def sync_master_to_model(master, model, generator=None, windows=None):
    """Copy the fp32 ``master`` tensors into the ``model`` tensors (the
    compute copy), in place.  With ``generator`` and a bf16 copy, each
    leaf is stochastically rounded under its own seed (``windows``: the
    slices of their leaves the tensors are, as ``ops/rounding.py`` takes
    them); else the copy rounds to nearest (the only rounding of an fp16
    copy, as the reference's ``astype``)."""
    if generator is None or not model or model[0].dtype != torch.bfloat16:
        torch._foreach_copy_(model, master)
        return
    fp32_to_bf16_sr_multi(master, draw_seeds(generator, (len(master),)),
                          model, windows)


def cast_moments(x, dtype, seed=None, rounding="sr", out=None):
    """Cast one fp32 moment leaf to its store ``dtype`` (into ``out`` when
    given).  bf16 with ``rounding="sr"`` rounds stochastically under the
    int32 ``seed``; another store type has no stochastic rounding and
    raises rather than hand back the biased round-to-nearest the caller
    asked to avoid."""
    if dtype == torch.float32 or x.dtype == dtype:
        return x if out is None else out.copy_(x)
    if rounding == "sr":
        if dtype != torch.bfloat16:
            raise NotImplementedError(
                f"stochastic rounding is implemented for bf16 moment stores "
                f"only (got {dtype}); use rounding=\"nearest\" explicitly "
                "if bias is acceptable")
        if seed is None:
            raise ValueError("stochastically-rounded moment casts need a "
                             "seed (the trainer passes a generator when the "
                             "optimizer wants one)")
        return fp32_to_bf16_sr(x, seed, out=out)
    return x.to(dtype) if out is None else out.copy_(x)


def grads_finite(grads):
    """Whether every element of every tensor of ``grads`` is finite, as a
    bool tensor on their device (the analogue of the reference's global
    all-finite check): one multi-tensor max-abs reduction, whose result
    is NaN or inf exactly where a tensor holds one; no host sync."""
    return torch.isfinite(
        torch.stack(torch._foreach_norm(grads, float("inf")))).all()


def default_scale_window(world_size, update_freq):
    """Reference default: ``2**14 / world_size / update_freq``
    (fp16_optimizer.py:255-264)."""
    return max(int(2 ** 14 / world_size / update_freq), 1)
