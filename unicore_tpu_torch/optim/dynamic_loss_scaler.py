"""Dynamic loss scaling of ``--fp16`` (counterpart of
``unicore_tpu/optim/dynamic_loss_scaler.py``).

Two forms, as there:

- :func:`scaler_init` / :func:`scaler_update`: the trainer's form.  The
  state is two device scalars, ``{"scale": fp32, "growth_tracker":
  int32}``, updated on the device from the step's overflow flag: shrink by
  ``scale_factor`` on overflow, grow by it after ``scale_window`` clean
  steps, clipped to ``[min_scale, max_scale]``.  The reference's tolerance
  fraction is host-side bookkeeping of the mirror below; tolerance 0 (the
  default) is exact here.  The floor abort is the trainer's, on the host.
- :class:`DynamicLossScaler`: the host-side mirror of the same policy with
  the reference's exception contract (``OverflowError`` to skip a step,
  ``FloatingPointError`` at the floor), for code that drives scaling from
  the host.
"""

import math

import torch


class DynamicLossScaler:
    def __init__(self, init_scale=2.0 ** 15, scale_factor=2.0,
                 scale_window=2000, tolerance=0.0, threshold=None,
                 min_loss_scale=1e-4):
        self.loss_scale = float(init_scale)
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.tolerance = tolerance
        self.threshold = threshold
        self.min_loss_scale = min_loss_scale
        self._clean_streak = 0      # good steps since the last grow/overflow
        self._window_steps = 0      # steps since the last rescale
        self._window_overflows = 0  # overflows in that window

    def scale(self, outputs):
        return self.loss_scale * outputs

    def update(self):
        """Record one clean step; grow after ``scale_window`` of them."""
        self._clean_streak += 1
        self._window_steps += 1
        if self._clean_streak >= self.scale_window:
            self.loss_scale *= self.scale_factor
            self._clean_streak = 0
            self._window_steps = 0
            self._window_overflows = 0

    def check_overflow(self, grad_norm):
        """Raise OverflowError (skip step) on a non-finite grad norm,
        shrinking the scale unless overflows are within ``tolerance`` of
        recent steps; FloatingPointError once the floor is hit."""
        if math.isfinite(grad_norm):
            return
        self._clean_streak = 0
        self._window_steps += 1
        self._window_overflows += 1
        rate = self._window_overflows / self._window_steps
        if rate >= self.tolerance:
            shrunk = self.loss_scale / self.scale_factor
            if self.threshold is not None:
                shrunk = max(shrunk, self.threshold)
            if shrunk <= self.min_loss_scale:
                raise FloatingPointError(
                    f"Minimum loss scale reached ({self.min_loss_scale}). "
                    "Your loss is probably exploding. Try lowering the "
                    "learning rate, using gradient clipping or increasing "
                    "the batch size.")
            self.loss_scale = shrunk
            self._window_steps = 0
            self._window_overflows = 0
        raise OverflowError(f"setting loss scale to: {self.loss_scale}")

    def state_dict(self):
        return {"loss_scale": self.loss_scale}

    def load_state_dict(self, state_dict):
        if "loss_scale" in state_dict:
            self.loss_scale = state_dict["loss_scale"]


def scaler_init(init_scale=2.0 ** 15, device="cpu"):
    """Scaler state as device scalars (the checkpoint's ``"scaler"``
    slot)."""
    return {
        "scale": torch.tensor(float(init_scale), dtype=torch.float32,
                              device=device),
        "growth_tracker": torch.zeros((), dtype=torch.int32, device=device),
    }


def scaler_update(state, overflow, scale_window, scale_factor=2.0,
                  min_scale=1e-4, max_scale=2.0 ** 24):
    """The new state after one step whose overflow flag is ``overflow``
    (a bool tensor on the state's device): shrink on overflow, grow after
    ``scale_window`` clean steps, in fp32 as the reference's jnp update."""
    tracker = torch.where(overflow, 0, state["growth_tracker"] + 1)
    grow = tracker >= scale_window
    scale = state["scale"]
    scale = torch.where(overflow, scale / scale_factor, scale)
    scale = torch.where(grow, scale * scale_factor, scale)
    scale = torch.clamp(scale, min_scale, max_scale)
    tracker = torch.where(grow, 0, tracker)
    return {"scale": scale, "growth_tracker": tracker.to(torch.int32)}
