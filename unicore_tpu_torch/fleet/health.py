"""Replica health model + circuit breaker for the fleet tier (a copy of
``unicore_tpu/fleet/health.py``; the port imports nothing of the JAX
package).

The fleet survives *planned* change (rolling restart, graceful drain);
this module is the *unplanned*-failure half: deciding, from the
router's seat, that a replica is gone.  Three independent signals feed
one per-replica state machine ``healthy -> suspect -> dead``:

- **Typed step exceptions.**  ``FleetRouter._step_replica`` catches
  what a replica's ``serve_step()`` raises (the engine lets a host
  fault escape only when the replica cannot go on) and records it
  here: an exception is a CRASH, dead immediately.  A device fault —
  a kernel that does not build or launch, a CUDA error — is not a
  replica's fault and goes past the router.
- **Progress watermark.**  ``ServeEngine.load_snapshot()`` carries
  ``last_progress`` — the monotonic retired-token watermark — plus the
  queue/pool gauges.  A replica that HOLDS WORK while its whole
  progress signature stays frozen for ``suspect_steps`` fleet steps is
  suspect; at ``dead_steps`` (or ``progress_budget_ms`` on the
  injectable clock, when configured) it is WEDGED: dead, whatever its
  queues claim.  The signature includes the queue depths and pool
  gauges so a long chunked prefill (which retires no token for a step
  or two but moves the pool) never false-positives.
- **Host-fault rate.**  ``host_faults`` is monotonic per engine; a
  delta of ``fault_budget`` faults inside ``fault_window`` fleet steps
  means the replica is eating its own batches faster than quarantine
  can contain — dead before the wedge detector would notice.

Every decision is a pure function of the observation sequence (fleet
step indices + snapshots + the injectable clock), so a seeded chaos
replay makes bit-identical detection/eviction decisions run to run.

The :class:`CircuitBreaker` gates the way BACK IN.  A replacement (or
recovered) replica never rejoins the ring directly: the breaker opens
when the replica dies, cools down for ``cooldown_steps``, then admits
ONE half-open probe — the router boots a ``factory(rid)`` replacement
off-ring and feeds it a canary request; only a completed canary closes
the breaker and restores the ring mapping.  ``flap_limit`` trips inside
``flap_window`` steps hold the breaker quarantined (no probes), so a
flapping replica cannot thrash the ring mapping — rejoin attempts are
bounded and visible in :meth:`CircuitBreaker.describe`.

Pure host logic — no tensors, no wall clock unless injected — so every
transition is directly unit-testable.
"""

import logging

logger = logging.getLogger(__name__)

HEALTHY, SUSPECT, DEAD = "healthy", "suspect", "dead"
CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

# load_snapshot keys whose CHANGE counts as replica progress: the
# retired-token watermark first, then every integer gauge a live step
# moves (admission, shed, expiry, prefix hits all count — a replica
# doing any of those is not wedged).  step_ms is excluded: a float that
# jitters per decode must not mask a genuine wedge.
PROGRESS_KEYS = ("last_progress", "host_faults", "waiting", "running",
                 "free_pages", "prefix_hits")

DEFAULT_SUSPECT_STEPS = 4
DEFAULT_DEAD_STEPS = 8
DEFAULT_FAULT_BUDGET = 3
DEFAULT_FAULT_WINDOW = 16


class ReplicaHealth:
    """Per-replica ``healthy -> suspect -> dead`` tracker.

    ``suspect_steps`` / ``dead_steps``: fleet steps of frozen progress
    signature (while the replica holds work) before the suspect/dead
    transitions.  ``progress_budget_ms``: optional wall budget on the
    injectable ``clock`` that can declare death earlier than the step
    budget (None = step counting only — the fully deterministic
    default).  ``fault_budget``/``fault_window``: host-fault delta
    threshold (see module docstring)."""

    def __init__(self, *, suspect_steps=DEFAULT_SUSPECT_STEPS,
                 dead_steps=DEFAULT_DEAD_STEPS, progress_budget_ms=None,
                 fault_budget=DEFAULT_FAULT_BUDGET,
                 fault_window=DEFAULT_FAULT_WINDOW, clock=None):
        if suspect_steps < 1 or dead_steps < suspect_steps:
            raise ValueError(
                f"need 1 <= suspect_steps <= dead_steps, got "
                f"{suspect_steps}/{dead_steps}"
            )
        self.suspect_steps = int(suspect_steps)
        self.dead_steps = int(dead_steps)
        self.progress_budget_ms = (
            None if progress_budget_ms is None else float(progress_budget_ms)
        )
        self.fault_budget = int(fault_budget)
        self.fault_window = int(fault_window)
        self._clock = clock
        self._state = {}  # rid -> per-replica dict

    def _slot(self, rid):
        return self._state.setdefault(rid, {
            "state": HEALTHY, "signature": None, "stall_steps": 0,
            "stalled_since_ms": None, "faults": [],  # [(step, cum), ...]
            "reason": None,
        })

    @staticmethod
    def _signature(snap):
        return tuple(snap[k] for k in PROGRESS_KEYS)

    def _now_ms(self):
        return None if self._clock is None else self._clock() * 1e3

    # -- observations ---------------------------------------------------

    def record_exception(self, rid, exc, *, step):
        """A typed step exception caught at the router loop: the
        replica CRASHED.  Dead immediately — the engine only re-raises
        out of ``serve_step`` when it cannot continue."""
        s = self._slot(rid)
        s["state"] = DEAD
        s["reason"] = (f"crash at fleet step {step}: "
                       f"{type(exc).__name__}: {exc}")
        return DEAD

    def observe(self, rid, snap, has_work, *, step):
        """One post-step observation of a live replica; returns the new
        state.  Deterministic in (step sequence, snapshots, clock)."""
        s = self._slot(rid)
        if s["state"] == DEAD:
            return DEAD

        # host-fault rate: delta inside the sliding step window
        faults = s["faults"]
        faults.append((step, snap["host_faults"]))
        while faults and faults[0][0] < step - self.fault_window:
            faults.pop(0)
        fault_delta = snap["host_faults"] - faults[0][1]
        if fault_delta >= self.fault_budget:
            s["state"] = DEAD
            s["reason"] = (
                f"host-fault rate: {fault_delta} faults inside "
                f"{self.fault_window} fleet steps (budget "
                f"{self.fault_budget})"
            )
            return DEAD

        # progress watermark: frozen signature while holding work
        sig = self._signature(snap)
        if not has_work or sig != s["signature"]:
            s["signature"] = sig
            s["stall_steps"] = 0
            s["stalled_since_ms"] = None
            s["state"] = HEALTHY
            s["reason"] = None
            return HEALTHY
        s["stall_steps"] += 1
        now_ms = self._now_ms()
        if s["stalled_since_ms"] is None and now_ms is not None:
            s["stalled_since_ms"] = now_ms
        stalled_ms = (None if now_ms is None or s["stalled_since_ms"] is None
                      else now_ms - s["stalled_since_ms"])
        over_ms = (self.progress_budget_ms is not None
                   and stalled_ms is not None
                   and stalled_ms > self.progress_budget_ms)
        if s["stall_steps"] >= self.dead_steps or over_ms:
            s["state"] = DEAD
            s["reason"] = (
                f"wedged: no progress for {s['stall_steps']} fleet "
                f"steps (budget {self.dead_steps})"
                + (f" / {stalled_ms:.0f} ms (budget "
                   f"{self.progress_budget_ms:.0f} ms)" if over_ms else "")
                + f" with work queued (last_progress={snap['last_progress']})"
            )
            return DEAD
        if s["stall_steps"] >= self.suspect_steps:
            if s["state"] != SUSPECT:
                logger.warning(
                    "replica %r SUSPECT: no progress for %d fleet steps "
                    "with work queued", rid, s["stall_steps"],
                )
            s["state"] = SUSPECT
        return s["state"]

    # -- queries --------------------------------------------------------

    def state(self, rid):
        return self._slot(rid)["state"]

    def reason(self, rid):
        return self._slot(rid)["reason"]

    def reset(self, rid):
        """Forget a replica's history (its REPLACEMENT starts healthy —
        the old engine's stall/fault record must not taint it)."""
        self._state.pop(rid, None)

    def describe(self, rid):
        s = self._slot(rid)
        return {"state": s["state"], "stall_steps": s["stall_steps"],
                "reason": s["reason"]}


class CircuitBreaker:
    """One replica slot's rejoin gate: ``closed -> open -> half_open ->
    closed``, with flap quarantine.

    - :meth:`trip` (the replica died, or its canary failed): ``open``,
      trip recorded at the given fleet step.
    - :meth:`ready`: True once ``cooldown_steps`` have passed since the
      last trip AND the breaker is not flap-quarantined — the router
      may launch ONE probe.
    - :meth:`probe`: ``half_open`` (canary in flight).
    - :meth:`succeed`: ``closed`` — full ring rejoin.
    - Quarantine: ``flap_limit`` trips inside the last ``flap_window``
      steps refuse further probes until the window slides past them —
      a flapping replica's rejoin attempts are bounded at
      ``flap_limit`` per window instead of thrashing the ring."""

    def __init__(self, *, cooldown_steps=8, flap_limit=3,
                 flap_window=128):
        if cooldown_steps < 1 or flap_limit < 1 or flap_window < 1:
            raise ValueError("breaker knobs must be >= 1")
        self.cooldown_steps = int(cooldown_steps)
        self.flap_limit = int(flap_limit)
        self.flap_window = int(flap_window)
        self.state = CLOSED
        self.trips = []       # fleet-step indices of every trip
        self.attempts = 0     # half-open probes launched
        self._last_trip = None

    def trip(self, step):
        self.state = OPEN
        self.trips.append(int(step))
        self._last_trip = int(step)

    def arm(self, step):
        """Arm a FRESH slot for an immediate half-open probe (fleet
        scale-up): ``open`` with the cooldown already served
        and NO trip recorded — booting extra capacity is not a failure,
        so the flap window stays empty and a later genuine trip starts
        a clean history.  Only legal on a never-tripped breaker: the
        rejoin path for a slot that has actually failed must serve its
        cooldown."""
        if self.state != CLOSED or self.trips:
            raise RuntimeError(
                f"CircuitBreaker.arm() on a used slot (state "
                f"{self.state!r}, {len(self.trips)} trip(s)) — scale-up "
                "may only arm a fresh breaker"
            )
        self.state = OPEN
        self._last_trip = int(step) - self.cooldown_steps

    def fail(self, step):
        """The half-open canary failed: back to ``open`` (a fresh trip
        — the flap counter sees every failed rejoin)."""
        if self.state != HALF_OPEN:
            raise RuntimeError(
                f"CircuitBreaker.fail() in state {self.state!r} — only "
                "a half-open probe can fail"
            )
        self.trip(step)

    def quarantined(self, step):
        """Flap hold: ``flap_limit`` trips inside the trailing
        ``flap_window`` steps."""
        recent = [t for t in self.trips if t > step - self.flap_window]
        return len(recent) >= self.flap_limit

    def ready(self, step):
        """May the router launch a probe at fleet step ``step``?"""
        if self.state != OPEN or self._last_trip is None:
            return False
        if step - self._last_trip < self.cooldown_steps:
            return False
        return not self.quarantined(step)

    def probe(self, step):
        if not self.ready(step):
            raise RuntimeError(
                f"CircuitBreaker.probe() while not ready (state "
                f"{self.state!r}, step {step})"
            )
        self.state = HALF_OPEN
        self.attempts += 1

    def succeed(self, step):
        if self.state != HALF_OPEN:
            raise RuntimeError(
                f"CircuitBreaker.succeed() in state {self.state!r} — "
                "only a half-open probe can close the breaker"
            )
        del step
        self.state = CLOSED

    def describe(self):
        return {"state": self.state, "trips": len(self.trips),
                "rejoin_attempts": self.attempts}


__all__ = ["ReplicaHealth", "CircuitBreaker", "HEALTHY", "SUSPECT",
           "DEAD", "CLOSED", "OPEN", "HALF_OPEN", "PROGRESS_KEYS"]
