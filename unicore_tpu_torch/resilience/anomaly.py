"""In-step anomaly guard: detection on the step's device, escalation on
the host (counterpart of ``unicore_tpu/resilience/anomaly.py``).

The guard state is six 0-dim tensors on the step's device: an fp32 EMA
of the step loss (``loss_ema``) and of its square (``loss_emsq``), and
int32 counters of the clean steps folded in (``count``), the current run
of anomalous steps (``streak``), and the totals of skips and spike
detections.  A step is a SPIKE when its loss exceeds ``ema + max(factor *
sigma, margin)`` after ``warmup`` clean steps; a non-finite gradient is
the trainer's overflow signal; both OR into one ``anomalous`` flag that
skips the update (params, optimizer state, EMA and the update count
untouched).  :class:`EscalationPolicy` walks consecutive anomalies up the
ladder skip -> loss-scale backoff (fp16) -> rewind to the last-good
snapshot -> abort.

:func:`guard_update` is the jitted JAX ``guard_update`` bit for bit: XLA
contracts ``eff * ema + (1 - eff) * loss`` (and the square's) into a
fused multiply-add that keeps ``eff * ema`` unrounded, and ``emsq - ema *
ema`` into one that keeps ``ema * ema`` unrounded; :func:`~unicore_tpu_
torch.utils.fma_fp32` gives both, and the square root goes through
float64 (correctly rounded back to fp32).  ``1 - 1 / (count + 1)`` is
fp32 arithmetic on the count, as jnp does it on the traced int.
"""

import logging
from dataclasses import dataclass

import torch

from ..utils import fma_fp32

logger = logging.getLogger(__name__)

# The ladder counters that survive a rewind: restoring the snapshot's own
# (clean, streak-0) values would let a persistent fault loop
# skip -> rewind forever with the abort rung unreachable.
GUARD_CARRY_KEYS = ("streak", "skips", "spikes")

GUARD_KEYS = ("loss_ema", "loss_emsq", "count", "streak", "skips", "spikes")


@dataclass(frozen=True)
class AnomalyGuardConfig:
    """The guard's constants and the host policy's thresholds.

    ``spike_factor <= 0`` disables spike detection; ``act_on_spike``
    decides whether a detected spike skips the update (``--anomaly-guard``)
    or is only counted.  The escalation thresholds count CONSECUTIVE
    anomalous steps."""

    spike_factor: float = 4.0
    spike_margin: float = 0.0
    window: int = 64          # EMA horizon in clean steps
    warmup: int = 16          # clean steps before spikes can fire
    act_on_spike: bool = False
    escalate: bool = False    # full ladder (else: skip / abort only)
    backoff_after: int = 2
    rewind_after: int = 3
    abort_after: int = 6

    @classmethod
    def from_args(cls, args):
        return cls(
            spike_factor=float(
                getattr(args, "loss_spike_factor", 4.0) or 0.0),
            spike_margin=float(
                getattr(args, "loss_spike_margin", 0.0) or 0.0),
            window=max(2, int(getattr(args, "loss_spike_window", 64) or 64)),
            warmup=max(1, int(getattr(args, "loss_spike_warmup", 16) or 16)),
            act_on_spike=bool(getattr(args, "anomaly_guard", False)),
            escalate=bool(getattr(args, "anomaly_guard", False)),
            backoff_after=int(getattr(args, "anomaly_backoff_after", 2) or 2),
            rewind_after=int(getattr(args, "anomaly_rewind_after", 3) or 3),
            abort_after=int(getattr(args, "anomaly_abort_after", 6) or 6),
        )


def guard_init(device="cpu"):
    """A fresh guard: every scalar 0 (the JAX ``guard_init``)."""
    return {k: torch.zeros((), dtype=torch.float32 if k.startswith("loss")
                           else torch.int32, device=device)
            for k in GUARD_KEYS}


def _f32(value, like):
    """An fp32 constant on ``like``'s device, by a fill (no host copy, so
    no sync)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def guard_update(guard, loss_mean, overflow, cfg):
    """One guard step on 0-dim tensors (``loss_mean`` fp32, ``overflow``
    bool), no host sync.  Returns ``(new_guard, anomalous, spike)``:
    ``anomalous`` is the skip signal (overflow always; a spike only under
    ``act_on_spike``); the EMA folds in clean, finite losses only."""
    ema, emsq, count = guard["loss_ema"], guard["loss_emsq"], guard["count"]
    loss_mean = loss_mean.float()
    if cfg.spike_factor > 0:
        warm = count >= cfg.warmup
        var = torch.clamp(fma_fp32(-ema, ema, emsq), min=0.0)
        sigma = torch.sqrt((var + _f32(1e-12, var)).double()).float()
        threshold = torch.maximum(_f32(cfg.spike_factor, sigma) * sigma,
                                  _f32(cfg.spike_margin, sigma))
        # NaN > x is False: a non-finite loss is the overflow's to flag
        spike = warm & ((loss_mean - ema)
                        > torch.maximum(threshold, _f32(1e-12, threshold)))
    else:
        spike = torch.zeros((), dtype=torch.bool, device=ema.device)
    anomalous = overflow | (spike & cfg.act_on_spike)
    fold = ~anomalous & torch.isfinite(loss_mean)
    beta = _f32(1.0 - 1.0 / cfg.window, ema)
    one = _f32(1.0, ema)
    # a running mean for the first steps, then decay beta
    eff = torch.where(count > 0, torch.minimum(
        beta, one - one / (count.float() + one)), torch.zeros_like(ema))
    rest = one - eff
    new_ema = torch.where(fold, fma_fp32(eff, ema, rest * loss_mean), ema)
    new_emsq = torch.where(
        fold, fma_fp32(eff, emsq, rest * loss_mean * loss_mean), emsq)
    new_guard = {
        "loss_ema": new_ema,
        "loss_emsq": new_emsq,
        "count": count + fold.to(torch.int32),
        "streak": torch.where(anomalous, guard["streak"] + 1,
                              torch.zeros_like(guard["streak"])),
        "skips": guard["skips"] + anomalous.to(torch.int32),
        "spikes": guard["spikes"] + spike.to(torch.int32),
    }
    return new_guard, anomalous, spike


class EscalationPolicy:
    """Host-side ladder over the device-side streak counter: maps one
    step's guard stats to an action; the trainer executes it.  Stages are
    cumulative — a streak of ``rewind_after`` has already skipped and
    backed off."""

    ACTIONS = ("none", "skip", "backoff", "rewind", "abort")

    def __init__(self, cfg, *, has_scaler, has_ring):
        self.cfg = cfg
        self.has_scaler = has_scaler
        self.has_ring = has_ring
        self.rewinds = 0
        self.aborts = 0

    def decide(self, anomalous, streak, overflow=True):
        """``overflow`` tells the anomaly kind: the backoff halves the fp16
        loss scale, which only an overflow calls for, so a spike-only
        streak skips at that rung instead."""
        if not anomalous:
            return "none"
        if not self.cfg.escalate:
            return "skip"
        if streak >= self.cfg.abort_after:
            return "abort"
        if streak >= self.cfg.rewind_after and self.has_ring:
            return "rewind"
        if (streak >= self.cfg.backoff_after and self.has_scaler
                and overflow):
            return "backoff"
        return "skip"
