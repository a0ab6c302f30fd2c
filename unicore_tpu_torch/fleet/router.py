"""FleetRouter: one router over N ServeEngine replicas (counterpart of
``unicore_tpu/fleet/router.py``, driving the port's
:class:`~unicore_tpu_torch.serve.engine.ServeEngine`).

- **Session affinity.**  A consistent-hash ring (:class:`~unicore_tpu_
  torch.fleet.ring.HashRing`) maps session keys to replicas: the same
  user lands on the same replica run after run (so a shared-prefix KV
  cache can hit), and membership churn remaps only the departing
  replica's sessions.
- **SLO-aware overflow.**  At admission the router polls every
  replica's :meth:`~unicore_tpu_torch.serve.engine.ServeEngine.
  load_snapshot` and overrides affinity BEFORE a queue blows a
  deadline: if the home replica is draining, would deterministically
  shed, or its projected wait (queue depth x smoothed step time x a
  safety factor) exceeds the request's deadline while a strictly
  less-loaded healthy replica exists, the request overflows to the
  least-loaded replica instead.
- **Rolling restart.**  :meth:`rolling_restart` upgrades the fleet one
  replica at a time with zero dropped admitted requests: the victim
  leaves the ring, its waiting requests are reclaimed and rerouted,
  its drain is triggered through the same flag path a delivered
  SIGTERM flips (:class:`~unicore_tpu_torch.resilience.preemption.
  ChildShutdown`), running work finishes while the rest of the fleet
  keeps serving, and the replacement rejoins the ring.
- **Failover.**  Every replica step is guarded: :meth:`_step_replica`
  catches a replica's host exceptions and feeds a per-replica
  :class:`~unicore_tpu_torch.fleet.health.ReplicaHealth` state machine
  (``healthy -> suspect -> dead``) that also watches the
  ``last_progress`` watermark and the host-fault rate.  A DEAD replica
  is evicted without a drain: it leaves the ring, its ChildShutdown is
  marked lost, and every salvaged request — waiting and running, with
  its generated-so-far tokens — is re-dispatched to a healthy replica
  through :meth:`~unicore_tpu_torch.serve.engine.ServeEngine.adopt`,
  which re-prefills prompt + generated and continues the stream.  A
  request that outlives ``max_failovers`` replica deaths terminates
  ``replica_lost``.  Rejoin goes through a :class:`~unicore_tpu_torch.
  fleet.health.CircuitBreaker`: after a cooldown the router boots
  ``factory(rid)`` off-ring, feeds it one canary request, and only a
  completed canary restores the ring mapping.  A device fault (a
  kernel that does not build or launch, a CUDA error) is not a
  replica's fault: it propagates out of the router.
- **Deploy.**  :meth:`attach_deploy` wires a :class:`~unicore_tpu_
  torch.deploy.rollout.RolloutController`, polled once per fleet step
  at the step boundary, where a weight swap is legal.
- **Elasticity.**  :meth:`scale_up` boots a new replica slot OFF-RING
  through the same breaker+canary probe a failover replacement uses (an
  armed, never-tripped breaker, so a scale-up boot is no failure in the
  flap window), and :meth:`retire_replica` retires a replica through
  the zero-drop drain a rolling restart uses, but NON-BLOCKING: the
  victim leaves the ring, its waiting requests reroute, its running work
  finishes over the following fleet steps, and :meth:`step` finalizes
  the retirement once the victim is idle.  The decisions live in
  :class:`~unicore_tpu_torch.fleet.autoscaler.FleetAutoscaler`, attached
  with :meth:`attach_autoscaler` and polled at the step boundary.  A
  retired replica's engine is closed and released, as an evicted one's
  is (the JAX router keeps every retired engine); its record stays in
  ``fleet_report()["retired"]``.

The router is single-threaded and cooperative: :meth:`step` advances
every replica by one ``serve_step`` (never the batch-blocking
``generate()``), so the whole fleet is deterministic under a seeded
trace replay (:mod:`~unicore_tpu_torch.fleet.trace`).
"""

import logging
import signal as _signal

from ..resilience.preemption import ChildShutdown
from ..serve.engine import DEVICE_FAULTS, ServeResult
from ..serve.scheduler import Request
from .health import DEAD, CircuitBreaker, ReplicaHealth
from .ring import HashRing

logger = logging.getLogger(__name__)

# stats the fleet report SUMS across replicas vs takes the MAX of —
# the stable aggregate gauge surface (satellite: per-replica metrics
# must roll up into ONE report, not N disjoint dicts)
SUM_STATS = (
    "prefills", "decode_steps", "decode_tokens", "generated_tokens",
    "shed", "expired", "quarantined", "host_faults",
    "capacity_failfast", "pool_exhausted_recoveries",
)
MAX_STATS = ("peak_waiting", "peak_pool_occupancy")

DEFAULT_MAX_FAILOVERS = 2
DEFAULT_PROBE_BUDGET_STEPS = 32

# EWMA weight for the per-replica smoothed step time: ~0.25 means one
# outlier decode moves the estimate a quarter of the way, and four
# normal steps pull it back — a single slow step cannot flap an
# SLO-overflow decision
DEFAULT_STEP_EWMA_ALPHA = 0.25


class FleetRouter:
    """Route requests over ``engines`` ({replica_id: ServeEngine}).

    ``shutdown``: an optional fleet-level :class:`GracefulShutdown`;
    every replica gets a :class:`ChildShutdown` wired to it, so one
    SIGTERM drains the whole fleet while :meth:`rolling_restart`
    targets one child at a time.  ``deadline_safety`` scales the
    projected-wait estimate before comparing against a deadline (>1 =
    overflow earlier).  ``service_floor_ms`` seeds the wait projection
    before the first decode has been measured.

    Failover knobs: ``factory(rid) -> ServeEngine`` builds
    the replacement a dead replica's circuit breaker probes (None =
    dead replicas stay lost); ``max_failovers`` bounds how many
    replica deaths one request may survive before it terminates
    ``replica_lost``; ``health`` is a pre-built
    :class:`~unicore_tpu_torch.fleet.health.ReplicaHealth` (None = defaults
    on ``clock``); ``breaker`` is a ``rid -> CircuitBreaker`` factory;
    ``probe_budget_steps`` bounds how long a half-open canary may run
    before the probe counts as failed."""

    def __init__(self, engines, *, vnodes=64, shutdown=None,
                 deadline_safety=1.5, service_floor_ms=1.0,
                 factory=None, max_failovers=DEFAULT_MAX_FAILOVERS,
                 health=None, breaker=None,
                 probe_budget_steps=DEFAULT_PROBE_BUDGET_STEPS,
                 step_ewma_alpha=DEFAULT_STEP_EWMA_ALPHA,
                 clock=None):
        if not engines:
            raise ValueError("a fleet needs at least one replica")
        self.engines = dict(engines)
        self.ring = HashRing(self.engines, vnodes=vnodes)
        self.shutdown = shutdown
        self.deadline_safety = float(deadline_safety)
        self.service_floor_ms = float(service_floor_ms)
        self.factory = factory
        self.max_failovers = int(max_failovers)
        self.health = health or ReplicaHealth(clock=clock)
        self._breaker_factory = breaker or (lambda rid: CircuitBreaker())
        self.probe_budget_steps = int(probe_budget_steps)
        self._children = {}
        for rid, eng in self.engines.items():
            child = self._make_child(rid)
            eng.shutdown = child
            self._children[rid] = child
        self._results = {}        # request_id -> ServeResult
        self._replica_of = {}     # request_id -> rid (current)
        self._session_of = {}     # request_id -> session key
        self._failovers = {}      # request_id -> replica deaths survived
        self.session_replicas = {}  # session -> [rid, ...] in route order
        self._fleet_step = 0
        self._breakers = {}       # rid -> CircuitBreaker (tripped slots)
        self._probation = {}      # rid -> half-open canary probe state
        self._lost = {}           # rid -> eviction record (most recent)
        self.step_ewma_alpha = float(step_ewma_alpha)
        self._step_ewma = {}      # rid -> smoothed step_ms (EWMA)
        self._retiring = {}       # rid -> in-flight scale-down record
        self._retired = {}        # rid -> completed retirement record
        self._managed = set()     # slots whose retry the autoscaler owns
        self.stats = {
            "routed": 0, "overflow_routed": 0, "rerouted": 0,
            "restarts": 0, "failovers": 0, "replica_lost": 0,
            "replicas_lost": 0, "rejoins": 0, "scale_ups": 0,
            "retired": 0,
        }
        self._auto_id = 0
        self._deploy = None  # RolloutController hook
        self._autoscaler = None  # FleetAutoscaler hook

    def attach_deploy(self, controller):
        """Wire a deploy :class:`~unicore_tpu_torch.deploy.rollout.
        RolloutController` into the router: it is polled once per
        fleet step (after every replica stepped — the step boundary),
        may divert a seeded slice of new submits to its off-ring
        canary, and observes every settled result for its TTFT
        watermark."""
        self._deploy = controller
        return controller

    def attach_autoscaler(self, scaler):
        """Wire a :class:`~unicore_tpu_torch.fleet.autoscaler.
        FleetAutoscaler` into the router: polled once per fleet step at
        the step boundary (after retirements finalize, before the deploy
        hook), its :meth:`describe` rides out through
        ``fleet_report()["autoscale"]``."""
        self._autoscaler = scaler
        return scaler

    def _make_child(self, rid):
        if self.shutdown is not None:
            return self.shutdown.child(str(rid))
        return ChildShutdown(name=str(rid))

    # -- admission ------------------------------------------------------

    def submit(self, request, session_key=None):
        """Admit one request: pick a replica (affinity unless the SLO
        says otherwise), enqueue it there, and record the assignment.
        Returns the chosen replica id."""
        if request.request_id is None:
            request.request_id = f"fleet-r{self._auto_id}"
            self._auto_id += 1
        rid = request.request_id
        if rid in self._replica_of or rid in self._results:
            raise ValueError(f"duplicate request_id {rid!r}")
        session = session_key if session_key is not None else rid
        if self._deploy is not None:
            canary = self._deploy.divert(request, session)
            if canary is not None and canary in self.engines:
                self.engines[canary].submit([request])
                self.stats["routed"] += 1
                self._record_assignment(rid, session, canary)
                return canary
        choice, reason = self._route(request, session)
        self.engines[choice].submit([request])
        self.stats["routed"] += 1
        if reason != "affinity":
            self.stats["overflow_routed"] += 1
        self._record_assignment(rid, session, choice)
        return choice

    def _record_assignment(self, request_id, session, choice):
        self._replica_of[request_id] = choice
        self._session_of[request_id] = session
        self.session_replicas.setdefault(session, [])
        if (not self.session_replicas[session]
                or self.session_replicas[session][-1] != choice):
            self.session_replicas[session].append(choice)

    def _route(self, request, session):
        if not self.engines:
            raise RuntimeError(
                "no live replicas: the whole fleet has been evicted "
                "(factory-less failover cannot rebuild it)"
            )
        snaps = {rid: eng.load_snapshot()
                 for rid, eng in self.engines.items()}
        healthy = [rid for rid in sorted(snaps)
                   if not snaps[rid]["draining"]]
        if not healthy:
            # every replica draining: honor affinity and let the home
            # replica's own shed path report the overload visibly
            return self.ring.lookup(session), "all-draining"
        home = self.ring.lookup(session)
        if home not in healthy:
            return self._least_loaded(healthy, snaps), "drain-overflow"
        if self._would_shed(request, snaps[home]):
            alt = self._least_loaded(healthy, snaps)
            if alt != home:
                return alt, "shed-overflow"
        if self._would_blow_deadline(request, snaps[home], home):
            alt = self._least_loaded(healthy, snaps)
            if (alt != home
                    and self._load_key(snaps[alt], alt)
                    < self._load_key(snaps[home], home)):
                return alt, "slo-overflow"
        return home, "affinity"

    @staticmethod
    def _load_key(snap, rid):
        """Deterministic total order on load: queue depth first, then
        pool pressure, replica id as the tiebreak."""
        return (snap["waiting"] + snap["running"],
                -snap["free_pages"], str(rid))

    def _least_loaded(self, rids, snaps):
        return min(rids, key=lambda r: self._load_key(snaps[r], r))

    @staticmethod
    def _would_shed(request, snap):
        """True when the home engine's bounded queue would shed this
        request on arrival (the engine's own add() bound: waiting >=
        max_waiting + free decode slots) — route around a
        deterministic shed instead of paying it."""
        del request
        if snap["max_waiting"] is None:
            return False
        return snap["waiting"] >= snap["max_waiting"] + snap["free_slots"]

    def _observe_step_ms(self, rid, raw_ms):
        """Fold one measured step time into the replica's EWMA.  Zero
        samples (no decode yet) are skipped so the floor seeds the
        estimate instead of a meaningless 0."""
        if raw_ms <= 0.0:
            return
        prev = self._step_ewma.get(rid)
        if prev is None:
            self._step_ewma[rid] = float(raw_ms)
        else:
            a = self.step_ewma_alpha
            self._step_ewma[rid] = a * float(raw_ms) + (1.0 - a) * prev

    def smoothed_step_ms(self, rid, snap=None):
        """The replica's EWMA-smoothed step time (ms), floored at
        ``service_floor_ms``.  Falls back to the instantaneous
        ``snap["step_ms"]`` sample only before the first observation —
        one slow step cannot flap an SLO-overflow decision."""
        ms = self._step_ewma.get(rid)
        if ms is None:
            ms = snap["step_ms"] if snap is not None else 0.0
        return max(ms, self.service_floor_ms)

    def _would_blow_deadline(self, request, snap, rid):
        if request.deadline_ms is None:
            return False
        step_ms = self.smoothed_step_ms(rid, snap)
        depth = snap["waiting"] + snap["running"]
        projected_ms = depth * step_ms * self.deadline_safety
        return projected_ms > request.deadline_ms

    # -- stepping -------------------------------------------------------

    def has_work(self):
        return (any(e.has_work() for e in self.engines.values())
                or any(p["engine"].has_work()
                       for p in self._probation.values())
                or (self._deploy is not None and self._deploy.active()))

    def step(self):
        """One cooperative fleet step: every replica advances by one
        guarded ``serve_step`` (deterministic replica order), half-open
        canaries step off-ring, and the circuit breakers tick.  Returns
        True while any replica still has work."""
        self._fleet_step += 1
        busy = False
        for rid in sorted(self.engines):
            if self._step_replica(rid):
                busy = True
        if self._step_probation():
            busy = True
        self._finalize_retirements()
        self._tick_breakers()
        if self._autoscaler is not None:
            # the same step boundary as the deploy hook: every replica
            # has stepped and retirements just finalized, so the gauges
            # the policy reads describe a settled fleet
            self._autoscaler.on_step(self._fleet_step)
        if self._deploy is not None:
            # the STEP BOUNDARY: every replica has stepped, nothing is
            # mid-dispatch — the only point where a weight swap is legal
            self._deploy.on_step(self._fleet_step)
        # a probe launched by the tick above has not stepped yet: keep
        # the drive loop alive until its canary settles; an in-flight
        # retirement or an active rollout likewise holds the loop open
        return (busy or bool(self._probation) or bool(self._retiring)
                or (self._deploy is not None and self._deploy.active()))

    def _step_replica(self, rid):
        """One GUARDED serve_step on replica ``rid``: typed fault
        handling plus health recording.  A host exception out of a step
        is a replica CRASH: the replica is evicted and its work fails
        over; the exception never reaches the fleet loop.  A device
        fault (``DEVICE_FAULTS``: a kernel that does not build or
        launch, a CUDA error) is the card's, not the replica's, and
        propagates.  A healthy step feeds
        the progress/fault-rate health model, which can likewise
        declare the replica dead (wedge detection)."""
        eng = self.engines.get(rid)
        if eng is None:
            return False  # evicted earlier this very fleet step
        try:
            busy = bool(eng.serve_step())
        except DEVICE_FAULTS:
            raise
        except Exception as exc:  # noqa: BLE001 - replica fault != fleet fault
            self.health.record_exception(rid, exc, step=self._fleet_step)
            self._evict_replica(rid)
            # eviction IS progress: the salvage may have been adopted
            # onto a replica that already stepped THIS fleet step, so
            # the drive loop must come around again or it strands them
            return True
        snap = eng.load_snapshot()
        self._observe_step_ms(rid, snap["step_ms"])
        state = self.health.observe(
            rid, snap, eng.has_work(),
            step=self._fleet_step,
        )
        if state == DEAD:
            self._evict_replica(rid)
            return True
        return busy

    def collect(self):
        """Harvest finished results from every replica into the
        router's result map (keyed by request_id)."""
        for rid in sorted(self.engines):
            for res in self.engines[rid].collect_finished():
                self._settle_result(res)
        return self._results

    def _settle_result(self, res):
        self._results[res.request_id] = res
        self._replica_of.pop(res.request_id, None)
        self._session_of.pop(res.request_id, None)
        self._failovers.pop(res.request_id, None)
        if self._deploy is not None:
            self._deploy.observe_result(res)

    def run_until_complete(self):
        """Drive the whole fleet to an empty queue and return the
        result map.  (The trace replayer interleaves arrivals instead
        — see :func:`~unicore_tpu_torch.fleet.trace.replay_trace`.)"""
        while self.step():
            self.collect()
        return self.collect()

    def results(self):
        """A view of every result harvested so far (the harness /
        one-shot CLI surface).  A LONG-LIVED router must use
        :meth:`take_results` instead — results carry full prompt and
        token lists, and a map that only ever grows is the host-memory
        shape the serve tier's bounded queues exist to prevent."""
        return dict(self._results)

    def take_results(self):
        """Drain and return the harvested results — the long-running
        caller's surface: once taken, the router forgets them, so its
        memory stays flat in requests served."""
        self.collect()
        out, self._results = self._results, {}
        return out

    # -- failover --------------------------------------------

    def _evict_replica(self, rid):
        """Evict a DEAD replica without a drain: leave the ring, mark
        its ChildShutdown lost (a zombie sheds, never serves), salvage
        every queued/running request WITH its generated tokens, trip
        the slot's circuit breaker, and re-dispatch the salvage to
        healthy replicas.  Deterministic: the salvage order is
        running-first then waiting (the preemption priority), and
        every routing decision goes through the same ``_route``."""
        eng = self.engines.pop(rid)
        reason = self.health.reason(rid) or "dead"
        if rid in self._retiring:
            # the victim died MID-RETIRE: the fleet already decided it
            # does not need this capacity, so the slot must not probe a
            # replacement on its own: record the retirement as died and
            # leave any retry to the autoscaler
            rec = self._retiring.pop(rid)
            self._managed.add(rid)
            self._retired[rid] = {
                "fleet_step": self._fleet_step, "since": rec["since"],
                "rerouted": rec["rerouted"], "drain": None,
                "pool_idle": False, "died": True,
            }
        self.ring.discard(rid)
        self._step_ewma.pop(rid, None)
        child = self._children.pop(rid, None)
        if child is not None:
            child.mark_lost()
        # results the replica finished BEFORE dying are valid — harvest
        # them ahead of the salvage so they never re-dispatch
        try:
            for res in eng.collect_finished():
                self._settle_result(res)
        except Exception as e:  # noqa: BLE001 - dying replica, best effort
            logger.warning("harvest from dead replica %r failed: %s",
                           rid, e)
        try:
            salvaged = eng.reclaim_waiting(include_running=True)
        except Exception as e:  # noqa: BLE001 - dying replica, best effort
            salvaged = []
            logger.error(
                "salvage from dead replica %r failed (%s) — its "
                "in-flight requests are lost and will be reported as "
                "replica_lost only if resubmitted", rid, e,
            )
        eng.close()  # its watchdog thread must not outlive the replica
        self.stats["replicas_lost"] += 1
        self._lost[rid] = {
            "reason": reason, "fleet_step": self._fleet_step,
            "salvaged": len(salvaged),
        }
        breaker = self._breakers.get(rid)
        if breaker is None:
            breaker = self._breakers[rid] = self._breaker_factory(rid)
        breaker.trip(self._fleet_step)
        logger.error(
            "replica %r EVICTED at fleet step %d (%s): %d request(s) "
            "fail over to %d surviving replica(s)",
            rid, self._fleet_step, reason, len(salvaged),
            len(self.engines),
        )
        for req, generated in salvaged:
            self._failover_request(req, generated)

    def _failover_request(self, req, generated):
        """Re-dispatch one salvaged request: a healthy replica adopts
        it (re-prefill of prompt+generated; absolute-step sampling
        keeps the continuation token-identical), unless it has now
        outlived ``max_failovers`` replicas — then it terminates with
        the typed reason ``replica_lost`` instead of looping through
        every future death."""
        rid = req.request_id
        session = self._session_of.pop(rid, None)
        if session is None:
            session = rid
        self._replica_of.pop(rid, None)
        count = self._failovers.get(rid, 0) + 1
        self._failovers[rid] = count
        if count > self.max_failovers or not self.engines:
            self._terminate_replica_lost(req, generated, count)
            return None
        choice, reason = self._route(req, session)
        try:
            seq = self.engines[choice].adopt(req, generated=generated)
        except ValueError as exc:
            # the salvage cannot run on the target (heterogeneous
            # fleet: prompt+generated outgrows its pool) — typed
            # terminal, never an exception out of the fleet loop
            logger.error(
                "failover: request %r cannot be adopted by %r (%s)",
                rid, choice, exc,
            )
            self._terminate_replica_lost(req, generated, count,
                                         why=str(exc))
            return None
        self.stats["failovers"] += 1
        if reason != "affinity":
            self.stats["overflow_routed"] += 1
        self._record_assignment(rid, session, choice)
        logger.warning(
            "failover %d/%d: request %r re-dispatched to %r with %d "
            "generated token(s) carried (%s)",
            count, self.max_failovers, rid, choice, len(generated),
            reason,
        )
        return None if seq.done else choice

    def _terminate_replica_lost(self, req, generated, count, why=None):
        if why is None:
            why = ("no live replica remains" if not self.engines else
                   f"outlived max_failovers={self.max_failovers} replicas")
        logger.error(
            "request %r terminated 'replica_lost' after %d replica "
            "death(s): %s", req.request_id, count, why,
        )
        self.stats["replica_lost"] += 1
        self._settle_result(ServeResult(
            request_id=req.request_id, prompt=list(req.prompt),
            tokens=list(generated), finish_reason="replica_lost",
            ttft_ms=None, evictions=0,
        ))

    # -- circuit-breaker rejoin -----------------------------------------

    def _tick_breakers(self):
        """Launch half-open probes for every OPEN breaker whose
        cooldown has elapsed and that is not flap-quarantined.  No-op
        without a replacement ``factory``."""
        if self.factory is None:
            return
        for rid in sorted(self._breakers):
            if rid in self.engines or rid in self._probation:
                continue
            if rid in self._managed:
                # an autoscaler-owned slot: whether and when to retry
                # the boot is the policy's call, bounded by its boot
                # budget; the router must not retry behind its back
                continue
            if self._breakers[rid].ready(self._fleet_step):
                self._start_probation(rid)

    def _start_probation(self, rid):
        """Boot ``factory(rid)`` OFF the ring and feed it one canary
        request; only a completed canary closes the breaker and
        restores the ring mapping (half-open probe)."""
        breaker = self._breakers[rid]
        breaker.probe(self._fleet_step)
        try:
            eng = self.factory(rid)
            canary_id = f"canary-{rid}-{breaker.attempts}"
            eng.submit([Request(prompt=[1], max_new_tokens=1, seed=0,
                                request_id=canary_id)])
        except Exception as exc:  # noqa: BLE001 - a bad factory must not kill the fleet
            logger.error("probe factory for replica %r failed: %r",
                         rid, exc)
            breaker.fail(self._fleet_step)
            return
        self._probation[rid] = {
            "engine": eng, "canary": canary_id,
            "since": self._fleet_step,
        }
        logger.warning(
            "replica %r HALF-OPEN: probing replacement with canary %r "
            "(attempt %d)", rid, canary_id, breaker.attempts,
        )

    def _step_probation(self):
        """Advance every half-open canary one step (off-ring, guarded
        like any replica step).  A completed canary rejoins the
        replica; a crash, a failed finish, or a blown probe budget
        trips the breaker again."""
        busy = False
        for rid in sorted(self._probation):
            probe = self._probation[rid]
            eng = probe["engine"]
            try:
                eng.serve_step()
                done = {r.request_id: r for r in eng.collect_finished()}
            except DEVICE_FAULTS:
                raise
            except Exception as exc:  # noqa: BLE001 - probe fault stays in the probe
                self.health.record_exception(rid, exc,
                                             step=self._fleet_step)
                self._fail_probation(
                    rid, f"canary crashed: {type(exc).__name__}: {exc}")
                continue
            res = done.get(probe["canary"])
            if res is not None:
                if res.finish_reason in ("eos", "length"):
                    self._rejoin(rid)
                else:
                    self._fail_probation(
                        rid, f"canary finished {res.finish_reason!r}")
                continue
            if self._fleet_step - probe["since"] > self.probe_budget_steps:
                self._fail_probation(
                    rid, f"canary made no progress within "
                         f"{self.probe_budget_steps} fleet steps")
                continue
            busy = True  # canary in flight keeps the fleet stepping
        return busy

    def _fail_probation(self, rid, why):
        self._probation.pop(rid)["engine"].close()
        self._breakers[rid].fail(self._fleet_step)
        quarantined = self._breakers[rid].quarantined(self._fleet_step)
        logger.error(
            "replica %r probe FAILED (%s): breaker re-opens%s",
            rid, why,
            " and the slot is flap-QUARANTINED" if quarantined else "",
        )

    def _rejoin(self, rid):
        """Full ring rejoin after a completed canary: fresh child,
        fresh health history, breaker closed.  Minimal-remap means the
        replica's old sessions come straight back to it — warm prefix
        pages and all, on a recovered (rather than replaced) engine."""
        probe = self._probation.pop(rid)
        eng = probe["engine"]
        child = self._make_child(rid)
        eng.shutdown = child
        self._children[rid] = child
        self.engines[rid] = eng
        self.ring.add(rid)
        self.health.reset(rid)
        self._step_ewma.pop(rid, None)  # fresh engine, fresh estimate
        self._breakers[rid].succeed(self._fleet_step)
        was_scale_up = rid in self._managed
        self._managed.discard(rid)  # a full member retries like any slot
        if was_scale_up:
            self.stats["scale_ups"] += 1
        self.stats["rejoins"] += 1
        logger.warning(
            "replica %r REJOINED the ring at fleet step %d (canary "
            "completed; breaker closed)", rid, self._fleet_step,
        )

    # -- elasticity -----------------------------------------------------

    def scale_up(self, rid):
        """Boot a new replica slot OFF-RING through the breaker's canary
        probe path: the slot gets an armed, never-tripped breaker
        (:meth:`~unicore_tpu_torch.fleet.health.CircuitBreaker.arm`:
        probe-ready at once, an empty flap window), ``factory(rid)``
        boots off the ring, and only a completed canary joins it
        (:meth:`_rejoin`).  A replica that fails its canary never takes
        traffic; whether to retry is the autoscaler's call (the slot is
        managed, so :meth:`_tick_breakers` does not retry it).  Returns
        True while the boot is in flight (canary pending), False if the
        factory failed outright."""
        if self.factory is None:
            raise RuntimeError("scale_up needs a replacement factory")
        if (rid in self.engines or rid in self._probation
                or rid in self._retiring):
            raise ValueError(f"replica id {rid!r} already in use")
        breaker = self._breakers.get(rid)
        if breaker is None:
            breaker = self._breakers[rid] = self._breaker_factory(rid)
            breaker.arm(self._fleet_step)
        elif not breaker.ready(self._fleet_step):
            raise RuntimeError(
                f"scale_up({rid!r}): slot breaker not ready (state "
                f"{breaker.state!r}) — a failed boot must serve its "
                "cooldown before a retry"
            )
        self._managed.add(rid)
        self._retired.pop(rid, None)
        self._start_probation(rid)
        return rid in self._probation

    def retire_replica(self, rid, *, signum=_signal.SIGTERM):
        """Begin retiring replica ``rid`` (scale-down) through the
        zero-drop drain a rolling restart uses, but NON-BLOCKING: leave
        the ring (its sessions remap minimally), request the drain
        through its ChildShutdown, reroute its reclaimed waiting
        requests (they hold no pool pages), and return.  The victim's
        running work finishes over the following fleet steps while the
        rest of the fleet keeps serving, and :meth:`step` finalizes the
        retirement once the victim is idle."""
        if rid not in self.engines:
            raise ValueError(f"no live replica {rid!r} to retire")
        if rid in self._retiring:
            raise ValueError(f"replica {rid!r} is already retiring")
        eng = self.engines[rid]
        self.ring.remove(rid)
        # drain FIRST: the victim's snapshot then reports draining, so
        # the reroute below can never route back onto it
        self._children[rid].request(signum)
        rerouted = eng.reclaim_waiting()
        for req in rerouted:
            self._replica_of.pop(req.request_id, None)
            sess = self._session_of.pop(req.request_id, None)
            self.submit(req, session_key=sess)
            self.stats["rerouted"] += 1
        self._retiring[rid] = {
            "since": self._fleet_step, "rerouted": len(rerouted),
        }
        logger.warning(
            "replica %r RETIRING at fleet step %d: off the ring, %d "
            "waiting request(s) rerouted, running work draining",
            rid, self._fleet_step, len(rerouted),
        )

    def _finalize_retirements(self):
        """Complete every in-flight scale-down whose victim has gone
        idle: finalize its drain report, verify that its pool ends idle
        (pages leaked across a retirement would be invisible forever),
        harvest its last results, and remove the replica.  The engine is
        then closed and released, as an evicted one is: its pool and
        watchdog leave the card.  A victim that died mid-drain was
        recorded by :meth:`_evict_replica` (failover salvaged it)."""
        for rid in sorted(self._retiring):
            eng = self.engines.get(rid)
            if eng is None:
                continue  # died mid-retire; eviction recorded it
            if eng.has_work():
                continue
            self._step_replica(rid)  # idle call finalizes the drain report
            if rid not in self.engines:
                continue  # declared dead on its very last step
            rep = eng.drain_report
            if rep is None:
                # idle when the drain landed: the zero report of the same
                # shape, so every retirement records its drain
                rep = self._zero_drain_report(eng)
            for res in eng.collect_finished():
                self._settle_result(res)
            if not eng.pool.is_idle():
                raise RuntimeError(
                    f"replica {rid!r} retired but its pool is not idle "
                    "— pages leaked across the scale-down"
                )
            eng.pool.check_invariants()
            rec = self._retiring.pop(rid)
            del self.engines[rid]
            self._step_ewma.pop(rid, None)
            child = self._children.pop(rid, None)
            if child is not None:
                child.mark_retired()
            self.health.reset(rid)
            eng.close()  # its watchdog thread must not outlive the replica
            self.stats["retired"] += 1
            self._retired[rid] = {
                "fleet_step": self._fleet_step, "since": rec["since"],
                "rerouted": rec["rerouted"], "drain": rep,
                "pool_idle": True, "died": False,
            }
            logger.warning(
                "replica %r RETIRED at fleet step %d (drained in %d "
                "fleet step(s), pool idle)", rid, self._fleet_step,
                self._fleet_step - rec["since"],
            )

    # -- rolling restart ------------------------------------------------

    def rolling_restart(self, factory=None, *, signum=_signal.SIGTERM,
                        max_steps=200000):
        """Upgrade the fleet ONE replica at a time, dropping nothing:

        for each replica (deterministic id order): leave the ring →
        reroute its reclaimed waiting requests → request drain through
        its ChildShutdown (``signum``, default SIGTERM — the flag path
        a real signal flips) → step the WHOLE fleet until the victim
        is idle (its running work finishes; everyone else keeps
        serving) → verify its pool is idle → install ``factory(rid)``
        (or :meth:`~ServeEngine.reopen` in place) → rejoin the ring.

        Returns the per-replica drain reports."""
        reports = {}
        for rid in sorted(self.engines):
            eng = self.engines.get(rid)
            if eng is None:
                continue  # evicted by failover while an earlier victim drained
            self.ring.remove(rid)
            rerouted = eng.reclaim_waiting()
            for req in rerouted:
                # the reroute is a fresh admission elsewhere: drop the
                # old assignment so submit() re-records it
                self._replica_of.pop(req.request_id, None)
                sess = self._session_of.pop(req.request_id, None)
                self.submit(req, session_key=sess)
                self.stats["rerouted"] += 1
            self._children[rid].request(signum)
            steps = 0
            while eng.has_work() and rid in self.engines:
                # step the FLEET, not just the victim: the rerouted
                # requests make progress while the victim drains
                self.step()
                self.collect()
                steps += 1
                if steps >= max_steps:
                    raise RuntimeError(
                        f"replica {rid!r} did not drain within "
                        f"{max_steps} fleet steps"
                    )
            if rid not in self.engines:
                # the victim died MID-DRAIN: failover already salvaged
                # its queues and tripped its breaker — the planned
                # restart for this replica is moot
                reports[rid] = None
                continue
            self._step_replica(rid)  # idle call finalizes the drain report
            reports[rid] = eng.drain_report
            if not eng.pool.is_idle():
                raise RuntimeError(
                    f"replica {rid!r} drained but its pool is not idle "
                    "— pages leaked across the restart"
                )
            self.collect()
            if factory is not None:
                eng.close()
                new_eng = factory(rid)
                child = self._make_child(rid)
                new_eng.shutdown = child
                self._children[rid] = child
                self.engines[rid] = new_eng
            else:
                eng.reopen()
            self.health.reset(rid)
            self.ring.add(rid)
            self.stats["restarts"] += 1
            logger.warning(
                "rolling restart: replica %r upgraded (%d rerouted, "
                "drain %s)", rid, len(rerouted), reports[rid],
            )
        return reports

    # -- fleet-wide drain ----------------------------------------------

    def drain(self, *, signum=None):
        """Drain EVERY replica (the fleet process's own shutdown path)
        and run the queues out; returns per-replica drain reports.  A
        replica that was already idle when the drain landed gets a
        synthesized zero report (same shape as a mid-stream drain's),
        so the operator always sees one record per replica."""
        for child in self._children.values():
            child.request(signum)
        self.run_until_complete()
        reports = {}
        for rid in sorted(self.engines):
            eng = self.engines[rid]
            self._step_replica(rid)  # idle call finalizes a pending report
            if rid not in self.engines:
                reports[rid] = None  # died on its very last step
                continue
            rep = eng.drain_report
            if rep is None:
                rep = self._zero_drain_report(eng)
            reports[rid] = rep
        return reports

    @staticmethod
    def _zero_drain_report(eng):
        """Drain-report shape for a replica that was already idle when
        the drain landed — same keys as a mid-stream drain's report."""
        signame = None
        if eng.shutdown is not None and eng.shutdown.signum:
            signame = _signal.Signals(eng.shutdown.signum).name
        return {
            "requested": True, "signal": signame, "drain_ms": 0.0,
            "drain_timeout_s": eng.drain_timeout,
            "shed": 0, "expired": 0, "deadline_exceeded": False,
            "pool_idle": eng.pool.is_idle(),
        }

    def close(self):
        """Stop the step watchdog of every live and probing replica
        (evicted, replaced and failed-probe replicas were closed as they
        left): the fleet process's last call."""
        for eng in self.engines.values():
            eng.close()
        for probe in self._probation.values():
            probe["engine"].close()

    # -- aggregate report ----------------------------------------------

    def _watchdog_status(self, eng):
        return None if eng.watchdog is None else eng.watchdog.status()

    def fleet_report(self):
        """ONE report for the whole fleet: per-replica stats rolled up
        (sums for counters, maxes for peaks) plus the router's own
        routing/affinity/failover counters and the health + breaker
        surfaces, the scale-downs in flight and done, and the
        autoscaler's :meth:`~unicore_tpu_torch.fleet.autoscaler.
        FleetAutoscaler.describe`."""
        agg = {k: 0 for k in SUM_STATS}
        agg.update({k: 0 for k in MAX_STATS})
        for eng in self.engines.values():
            for k in SUM_STATS:
                agg[k] += eng.stats.get(k, 0)
            for k in MAX_STATS:
                agg[k] = max(agg[k], eng.stats.get(k, 0))
        sessions = self.session_replicas
        moved = sum(1 for rids in sessions.values() if len(set(rids)) > 1)
        return {
            "replicas": len(self.engines),
            "router": dict(self.stats),
            "sessions": len(sessions),
            "sessions_multi_replica": moved,
            "aggregate": agg,
            "per_replica": {
                str(rid): self.engines[rid].load_snapshot()
                for rid in sorted(self.engines)
            },
            "health": {
                str(rid): dict(
                    self.health.describe(rid),
                    watchdog=self._watchdog_status(self.engines[rid]),
                )
                for rid in sorted(self.engines)
            },
            "lost": {str(rid): dict(rec)
                     for rid, rec in sorted(self._lost.items())},
            "breakers": {str(rid): br.describe()
                         for rid, br in sorted(self._breakers.items())},
            "probation": sorted(map(str, self._probation)),
            "retiring": sorted(map(str, self._retiring)),
            "retired": {str(rid): dict(rec)
                        for rid, rec in sorted(self._retired.items())},
            "deploy": (None if self._deploy is None
                       else self._deploy.describe()),
            "autoscale": (None if self._autoscaler is None
                          else self._autoscaler.describe()),
        }
