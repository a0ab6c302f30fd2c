"""FleetAutoscaler: a deterministic elastic scaling policy (counterpart
of ``unicore_tpu/fleet/autoscaler.py``, over the port's
:class:`~unicore_tpu_torch.fleet.router.FleetRouter`).

A fixed replica count can answer a flash crowd only by shedding, and an
overnight lull keeps idle replicas on their cards.  This is a pure
host-side scaling policy stepped once per fleet-router step,
deterministic in (fleet-step sequence, ``load_snapshot()`` gauges): no
wall-clock read ever steers a decision, so a seeded scenario replay
(:func:`~unicore_tpu_torch.fleet.trace.scenario_trace`) makes identical
scaling decisions run to run.

**The signal** is the wait projection the router already uses for SLO
overflow (queue depth x smoothed step time x the router's
``deadline_safety``), aggregated fleet-wide as the mean projected wait
across SERVING replicas (retiring and off-ring replicas excluded: their
queues are someone else's).  Per-replica hot spots are the overflow
router's job; the autoscaler answers the capacity question.  Step time
comes from ``step_time_ms`` when set (the virtual step width a trace
replay advances per fleet step: the fully deterministic mode) or else
from the router's per-replica EWMA (smoothed, so one slow decode cannot
thrash the policy).

**The policy** is watermarks + hysteresis + cooldowns:

- pressure above ``high_watermark_ms`` for ``hysteresis_steps``
  CONSECUTIVE fleet steps, with the up-direction cooldown served and
  headroom under ``max_replicas`` (booting replicas count: capacity in
  flight is capacity) → **scale up**: boot ``a<seq>`` OFF-RING through
  the router's breaker+canary path
  (:meth:`~unicore_tpu_torch.fleet.router.FleetRouter.scale_up`).  A
  replica that fails its canary never takes traffic and counts against
  ``boot_budget``; the budget exhausted means no more boot attempts this
  process — a broken factory must not retry forever.
- pressure below ``low_watermark_ms`` for ``hysteresis_steps``
  consecutive steps, with the down-direction cooldown served, more than
  ``min_replicas`` serving, and NO boot or retirement in flight →
  **scale down**: retire the least-loaded replica (the router's own
  deterministic load order) through the zero-drop drain
  (:meth:`~unicore_tpu_torch.fleet.router.FleetRouter.retire_replica`).
- at ``max_replicas`` saturation the fleet degrades into the engines'
  own bounded deterministic shedding — never unbounded growth.

Every decision lands in a bounded decision log (fleet step, action,
replica, pressure); :meth:`describe` rides out through
``fleet_report()["autoscale"]``.  Pure host logic: no wall clock.
"""

import logging

logger = logging.getLogger(__name__)

DEFAULT_HIGH_WATERMARK_MS = 40.0
DEFAULT_LOW_WATERMARK_MS = 4.0
DEFAULT_HYSTERESIS_STEPS = 3
DEFAULT_COOLDOWN_STEPS = 16
DEFAULT_BOOT_BUDGET = 3
DECISION_LOG_LIMIT = 64


class FleetAutoscaler:
    """Elastic scaling policy over one :class:`~unicore_tpu_torch.fleet.
    router.FleetRouter`; attach with ``router.attach_autoscaler(...)``
    and the router polls :meth:`on_step` once per fleet step.

    ``min_replicas``/``max_replicas`` bound the serving fleet;
    ``high_watermark_ms``/``low_watermark_ms`` bracket the fleet-wide
    mean projected wait; ``hysteresis_steps`` is how many CONSECUTIVE
    over/under observations arm a decision; ``cooldown_steps`` is the
    per-direction refractory period between decisions;
    ``boot_budget`` bounds failed boot attempts for the whole process;
    ``step_time_ms`` pins the wait projection's step time (virtual
    replay width — the deterministic mode) instead of the router's
    measured EWMA.  (The JAX class's ``clock``, which it never reads, is
    left out.)"""

    def __init__(self, router, *, min_replicas=1, max_replicas=4,
                 high_watermark_ms=DEFAULT_HIGH_WATERMARK_MS,
                 low_watermark_ms=DEFAULT_LOW_WATERMARK_MS,
                 hysteresis_steps=DEFAULT_HYSTERESIS_STEPS,
                 cooldown_steps=DEFAULT_COOLDOWN_STEPS,
                 boot_budget=DEFAULT_BOOT_BUDGET,
                 step_time_ms=None):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, got "
                             f"{min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"need min_replicas <= max_replicas, got "
                f"{min_replicas} > {max_replicas}"
            )
        if hysteresis_steps < 1 or cooldown_steps < 0 or boot_budget < 0:
            raise ValueError("hysteresis/cooldown/boot-budget out of range")
        if not low_watermark_ms < high_watermark_ms:
            raise ValueError(
                f"need low_watermark_ms < high_watermark_ms, got "
                f"{low_watermark_ms} >= {high_watermark_ms}"
            )
        self.router = router
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.high_watermark_ms = float(high_watermark_ms)
        self.low_watermark_ms = float(low_watermark_ms)
        self.hysteresis_steps = int(hysteresis_steps)
        self.cooldown_steps = int(cooldown_steps)
        self.boot_budget = int(boot_budget)
        self.step_time_ms = (None if step_time_ms is None
                             else float(step_time_ms))
        self._pending = {}   # rid -> fleet step the boot launched
        self._seq = 0        # next scale-up replica id suffix
        self._over = 0       # consecutive steps above the high watermark
        self._under = 0      # consecutive steps below the low watermark
        self._last_up = None    # fleet step of the last scale-up
        self._last_down = None  # fleet step of the last scale-down
        self._boot_failures = 0
        self._scale_ups = 0
        self._scale_downs = 0
        self._last_pressure_ms = None
        self.decisions = []  # bounded (step, action, rid, pressure) log

    # -- signal ----------------------------------------------------------

    def _serving(self):
        """Replica ids that currently take ring traffic (live minus
        retiring), in deterministic id order."""
        return [rid for rid in sorted(self.router.engines)
                if rid not in self.router._retiring]

    def _pressure_ms(self, serving):
        """Fleet-wide mean projected wait (ms) across the serving
        replicas: queue depth x step time x the router's safety factor
        — the same projection SLO-overflow routing uses, aggregated."""
        if not serving:
            return None
        total = 0.0
        for rid in serving:
            snap = self.router.engines[rid].load_snapshot()
            if self.step_time_ms is not None:
                step_ms = max(self.step_time_ms,
                              self.router.service_floor_ms)
            else:
                step_ms = self.router.smoothed_step_ms(rid, snap)
            depth = snap["waiting"] + snap["running"]
            total += depth * step_ms * self.router.deadline_safety
        return total / len(serving)

    # -- policy ----------------------------------------------------------

    def on_step(self, fleet_step):
        """One policy step at the router's step boundary: settle
        pending boots, fold the pressure signal into the hysteresis
        counters, and make at most ONE scaling decision.  A pure
        function of the observation sequence — no wall clock."""
        self._settle_boots(fleet_step)
        serving = self._serving()
        pressure = self._pressure_ms(serving)
        self._last_pressure_ms = pressure
        if pressure is None:
            return
        if pressure > self.high_watermark_ms:
            self._over += 1
            self._under = 0
        elif pressure < self.low_watermark_ms:
            self._under += 1
            self._over = 0
        else:
            self._over = 0
            self._under = 0
        if self._should_scale_up(fleet_step, serving):
            self._scale_up(fleet_step, pressure)
        elif self._should_scale_down(fleet_step, serving):
            self._scale_down(fleet_step, serving, pressure)

    def _settle_boots(self, fleet_step):
        """Poll every in-flight boot: joined the ring (canary
        completed) or failed (gone from probation without joining —
        the canary failed or the factory blew up)."""
        for rid in sorted(self._pending):
            if rid in self.router.engines:
                self._pending.pop(rid)
                self._record(fleet_step, "joined", rid, None)
            elif rid not in self.router._probation:
                self._pending.pop(rid)
                self._boot_failures += 1
                self._record(fleet_step, "boot_failed", rid, None)
                logger.error(
                    "autoscale: replica %r failed its boot canary "
                    "(%d/%d boot failures) — it never took traffic",
                    rid, self._boot_failures, self.boot_budget,
                )

    def _should_scale_up(self, fleet_step, serving):
        if self._over < self.hysteresis_steps:
            return False
        if (self._last_up is not None
                and fleet_step - self._last_up < self.cooldown_steps):
            return False
        if len(serving) + len(self._pending) >= self.max_replicas:
            return False  # saturated: the engines shed deterministically
        if self._boot_failures >= self.boot_budget:
            return False  # boot budget exhausted: stop burning canaries
        return True

    def _should_scale_down(self, fleet_step, serving):
        if self._under < self.hysteresis_steps:
            return False
        if (self._last_down is not None
                and fleet_step - self._last_down < self.cooldown_steps):
            return False
        if len(serving) <= self.min_replicas:
            return False
        # one scale event at a time: a boot or retirement in flight
        # means the gauges describe a fleet mid-transition
        if self._pending or self.router._retiring:
            return False
        return True

    def _scale_up(self, fleet_step, pressure):
        rid = f"a{self._seq}"
        self._seq += 1
        booting = self.router.scale_up(rid)
        self._last_up = fleet_step
        self._over = 0
        if booting:
            self._pending[rid] = fleet_step
            self._scale_ups += 1
            self._record(fleet_step, "scale_up", rid, pressure)
            logger.warning(
                "autoscale: SCALE UP at fleet step %d (pressure "
                "%.1f ms > %.1f ms): booting replica %r off-ring",
                fleet_step, pressure, self.high_watermark_ms, rid,
            )
        else:
            self._boot_failures += 1
            self._record(fleet_step, "boot_failed", rid, pressure)

    def _scale_down(self, fleet_step, serving, pressure):
        snaps = {rid: self.router.engines[rid].load_snapshot()
                 for rid in serving}
        victim = min(serving,
                     key=lambda r: self.router._load_key(snaps[r], r))
        self.router.retire_replica(victim)
        self._last_down = fleet_step
        self._under = 0
        self._scale_downs += 1
        self._record(fleet_step, "scale_down", victim, pressure)
        logger.warning(
            "autoscale: SCALE DOWN at fleet step %d (pressure %.1f ms "
            "< %.1f ms): retiring least-loaded replica %r",
            fleet_step, pressure, self.low_watermark_ms, victim,
        )

    def _record(self, fleet_step, action, rid, pressure):
        self.decisions.append({
            "fleet_step": int(fleet_step), "action": action,
            "replica": str(rid),
            "pressure_ms": (None if pressure is None
                            else round(float(pressure), 3)),
        })
        if len(self.decisions) > DECISION_LOG_LIMIT:
            del self.decisions[:-DECISION_LOG_LIMIT]

    # -- report ----------------------------------------------------------

    def describe(self):
        """The ``fleet_report()["autoscale"]`` section, with the JAX
        package's keys."""
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "serving": len(self._serving()),
            "booting": sorted(map(str, self._pending)),
            "retiring": sorted(map(str, self.router._retiring)),
            "scale_ups": self._scale_ups,
            "scale_downs": self._scale_downs,
            "boot_failures": self._boot_failures,
            "boot_budget": self.boot_budget,
            "high_watermark_ms": self.high_watermark_ms,
            "low_watermark_ms": self.low_watermark_ms,
            "last_pressure_ms": (
                None if self._last_pressure_ms is None
                else round(self._last_pressure_ms, 3)),
            "decisions": [dict(d) for d in self.decisions],
        }


__all__ = ["FleetAutoscaler", "DEFAULT_HIGH_WATERMARK_MS",
           "DEFAULT_LOW_WATERMARK_MS", "DEFAULT_HYSTERESIS_STEPS",
           "DEFAULT_COOLDOWN_STEPS", "DEFAULT_BOOT_BUDGET"]
