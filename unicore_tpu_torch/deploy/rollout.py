"""Canary-gated rollout: new weights meet live traffic (counterpart of
``unicore_tpu/deploy/rollout.py``).

A verified manifest surfaces at the fleet router's step boundary and
advances through a small deterministic state machine, one transition
per fleet step:

``idle -> canary``
    ONE replica (lowest id) hot-swaps the new weights via
    :meth:`~unicore_tpu_torch.serve.engine.ServeEngine.swap_weights` —
    its KV pool, page tables and in-flight sequences survive — and
    leaves the ring, so new sessions route elsewhere while a seeded
    slice of live traffic (crc32 of the request id under the rollout
    seed, shed-safe) is diverted onto it, plus one synthetic probe so
    an idle fleet still gates.  The canary's pre-swap weights are kept
    as the host tree its ``params`` view gives.

``canary -> promote | rollback``
    SLO and health gates over the canary window: the engine's
    finite-logits quarantine counter (NaN weights surface here), host
    faults, the shed budget, the probe's finish reason, and the
    diverted requests' median TTFT against the pre-swap fleet
    watermark.  A failing gate swaps the canary back to its pre-swap
    weights, trips the breaker and quarantines the publish id — a
    poisoned or torn checkpoint never reaches a second replica.

``promote``
    The other replicas swap ONE PER FLEET STEP (zero-drop: a swap needs
    no drain).

Torn manifests and load or digest failures are condemned without any
swap.  While the breaker is OPEN, new manifests wait for the cooldown
(the newest pending one wins); a flap-quarantined breaker disables
deployments until an operator intervenes.
"""

import logging
import zlib
from collections import deque

from ..fleet.health import CLOSED, HALF_OPEN, CircuitBreaker
from ..serve.engine import DEVICE_FAULTS
from ..serve.scheduler import Request
from .loader import load_manifest_params

logger = logging.getLogger(__name__)

IDLE, CANARY, PROMOTE = "idle", "canary", "promote"


class RolloutController:
    """Drives canary-gated weight rollout over a
    :class:`~unicore_tpu_torch.fleet.router.FleetRouter`.

    All control flow advances in FLEET STEPS (``on_step`` fires at the
    router's step boundary), so trace replays are deterministic; the
    only wall-clock inputs are the engines' own injectable clocks.

    ``ttft_budget_ms=None`` disables the TTFT gate (the default — CPU
    test rigs have no meaningful latency floor); ``max_shed=None``
    disables the shed gate."""

    def __init__(self, router, subscriber, *, loader=None,
                 canary_steps=24, divert_period=4, seed=0,
                 ttft_budget_ms=None, max_shed=0, breaker=None):
        self.router = router
        self.subscriber = subscriber
        self._load = loader or load_manifest_params
        self.canary_steps = int(canary_steps)
        self.divert_period = max(1, int(divert_period))
        self.seed = int(seed)
        self.ttft_budget_ms = ttft_budget_ms
        self.max_shed = max_shed
        self.breaker = breaker or CircuitBreaker()
        self.state = IDLE
        self.current = None       # promoted Manifest (None = boot weights)
        self.previous = None
        self.quarantined = {}     # publish_id -> reason
        self.history = []         # [{publish_id, outcome, reason, step}]
        self.stats = {"manifests_seen": 0, "promotes": 0, "rollbacks": 0,
                      "swaps": 0, "diverted": 0}
        self._pending = None
        self._canary = None
        self._ttft = deque(maxlen=256)  # fleet-wide finished-request TTFTs
        router.attach_deploy(self)

    # -- router hooks ---------------------------------------------------

    def active(self):
        """True while a rollout (or a held pending manifest) needs the
        fleet to keep stepping."""
        return self.state != IDLE or self._pending is not None

    def observe_result(self, res):
        """Router settle hook: feed the TTFT watermark, and during a
        canary window collect the canary's own finished requests."""
        if res.ttft_ms is not None:
            self._ttft.append(res.ttft_ms)
        c = self._canary
        if c is None:
            return
        if res.request_id == c["probe_id"]:
            c["probe_result"] = res.finish_reason
        if res.request_id in c["diverted"]:
            c["finished"].append((res.finish_reason, res.ttft_ms))

    def divert(self, request, session):
        """Router submit hook: send the seeded slice of live traffic to
        the off-ring canary.  Shed-safe: a request the canary's bounded
        queue would reject keeps its normal routing."""
        del session
        c = self._canary
        if self.state != CANARY or c is None:
            return None
        eng = self.router.engines.get(c["rid"])
        if eng is None:
            return None
        if not self.router.ring.members():
            # every OTHER replica died mid-window: the off-ring canary
            # is the whole fleet — route to it rather than crash admission
            return c["rid"]
        key = f"{self.seed}:{request.request_id}".encode()
        if zlib.crc32(key) % self.divert_period != 0:
            return None
        if self.router._would_shed(request, eng.load_snapshot()):
            return None
        c["diverted"].add(request.request_id)
        self.stats["diverted"] += 1
        return c["rid"]

    def on_step(self, step):
        """One deploy transition at the fleet step boundary."""
        # harvest finished results NOW (callers may only collect at the
        # end of a replay): observe_result feeds the TTFT watermark and
        # the canary gates from the settle hook
        self.router.collect()
        if self.state == IDLE:
            self._poll(step)
        elif self.state == CANARY:
            self._step_canary(step)
        elif self.state == PROMOTE:
            self._step_promote(step)

    # -- idle: watch the publish dir ------------------------------------

    def _poll(self, step):
        m = self.subscriber.poll()
        for pid, path in self.subscriber.take_torn():
            self._condemn(pid, step,
                          f"torn manifest at {path} (bytes contradict "
                          f"the .sum marker)")
        if m is not None and m.publish_id not in self.quarantined:
            if self.current is None or m.publish_id > self.current.publish_id:
                self.stats["manifests_seen"] += 1
                self._pending = m  # newest wins over an earlier pending
        if self._pending is None:
            return
        if self.breaker.state == CLOSED:
            pass
        elif self.breaker.quarantined(step):
            logger.error(
                "deploy breaker is flap-QUARANTINED: dropping pending "
                "publish %d (deployments disabled until operator reset)",
                self._pending.publish_id,
            )
            self.history.append({
                "publish_id": self._pending.publish_id,
                "outcome": "held", "reason": "breaker quarantined",
                "step": step,
            })
            self._pending = None
            return
        elif self.breaker.ready(step):
            self.breaker.probe(step)
        else:
            return  # cooldown: hold the pending manifest
        manifest, self._pending = self._pending, None
        self._start_canary(manifest, step)

    # -- canary ---------------------------------------------------------

    def _start_canary(self, manifest, step):
        if not self.router.engines:
            self._condemn(manifest.publish_id, step,
                          "no live replicas to canary on")
            return
        rid = sorted(self.router.engines)[0]
        eng = self.router.engines[rid]
        try:
            params = self._load(manifest)
        except Exception as e:  # noqa: BLE001 - typed integrity/deploy faults
            self._condemn(manifest.publish_id, step,
                          f"load failed: {type(e).__name__}: {e}")
            return
        fallback = eng.params  # the host tree the engine serves
        base = {k: eng.stats[k]
                for k in ("quarantined", "host_faults", "shed")}
        ttft = sorted(self._ttft)
        watermark = ttft[len(ttft) // 2] if ttft else None
        try:
            eng.swap_weights(params)
        except DEVICE_FAULTS:
            raise  # a card fault is not the publish's: it propagates
        except Exception as e:  # noqa: BLE001 - WeightSwapError et al, typed
            self._condemn(manifest.publish_id, step,
                          f"swap rejected: {type(e).__name__}: {e}")
            return
        self.stats["swaps"] += 1
        self.router.ring.discard(rid)
        probe_id = f"deploy-canary-{manifest.publish_id}-{step}"
        try:
            eng.submit([Request(prompt=[1], max_new_tokens=4, seed=0,
                                request_id=probe_id)])
        except Exception as e:  # noqa: BLE001 - probe must not kill the fleet
            logger.error("canary probe submit failed: %r", e)
        self._canary = {
            "rid": rid, "manifest": manifest, "since": step,
            "params": params, "fallbacks": {rid: fallback},
            "base": base, "watermark": watermark,
            "probe_id": probe_id, "probe_result": None,
            "diverted": set(), "finished": [], "held_out": True,
            "promote_queue": [],
        }
        self.state = CANARY
        logger.warning(
            "publish %d CANARY on replica %r (off-ring, %d-step window)",
            manifest.publish_id, rid, self.canary_steps,
        )

    def _gate_failure(self, step):
        """First failing SLO/health gate, or None.  Counter gates run
        every step (fail fast); the probe/TTFT gates only decide at
        the window's end."""
        c = self._canary
        eng = self.router.engines.get(c["rid"])
        if eng is None:
            return "canary replica evicted during the window"
        if eng.stats["quarantined"] - c["base"]["quarantined"] > 0:
            return ("nonfinite logits quarantined on the canary "
                    "(finite-rows gate)")
        if eng.stats["host_faults"] - c["base"]["host_faults"] > 0:
            return "host faults on the canary"
        if (self.max_shed is not None
                and eng.stats["shed"] - c["base"]["shed"] > self.max_shed):
            return "canary shed over budget"
        if step - c["since"] < self.canary_steps:
            return None  # window still open; end-of-window gates wait
        if c["probe_result"] not in ("eos", "length"):
            return f"canary probe finished {c['probe_result']!r}"
        if self.ttft_budget_ms is not None and c["watermark"] is not None:
            samples = sorted(t for _, t in c["finished"] if t is not None)
            if samples:
                med = samples[len(samples) // 2]
                if med - c["watermark"] > self.ttft_budget_ms:
                    return (f"canary TTFT {med:.1f} ms over the pre-swap "
                            f"watermark {c['watermark']:.1f} ms by more "
                            f"than {self.ttft_budget_ms} ms")
        return "ok"

    def _step_canary(self, step):
        verdict = self._gate_failure(step)
        if verdict is None:
            return
        if verdict != "ok":
            self._rollback(step, verdict)
            return
        c = self._canary
        self.router.ring.add(c["rid"])
        c["held_out"] = False
        if self.breaker.state == HALF_OPEN:
            self.breaker.succeed(step)
        c["promote_queue"] = [r for r in sorted(self.router.engines)
                              if r != c["rid"]]
        self.state = PROMOTE
        logger.warning(
            "publish %d passed its canary gates: promoting %d more "
            "replica(s), one per fleet step",
            c["manifest"].publish_id, len(c["promote_queue"]),
        )

    # -- promote --------------------------------------------------------

    def _step_promote(self, step):
        c = self._canary
        q = c["promote_queue"]
        while q and q[0] not in self.router.engines:
            q.pop(0)  # evicted since the queue was built
        if q:
            rid = q.pop(0)
            eng = self.router.engines[rid]
            c["fallbacks"][rid] = eng.params
            try:
                eng.swap_weights(c["params"])
            except DEVICE_FAULTS:
                raise  # a card fault is not the publish's: it propagates
            except Exception as e:  # noqa: BLE001 - typed swap faults
                self._rollback(step,
                               f"promote swap on {rid} failed: "
                               f"{type(e).__name__}: {e}")
                return
            self.stats["swaps"] += 1
            return  # one replica per step: bounded per-step stall
        m = c["manifest"]
        self.previous, self.current = self.current, m
        self.stats["promotes"] += 1
        self.history.append({"publish_id": m.publish_id,
                             "outcome": "promote", "reason": "",
                             "step": step})
        self._canary = None
        self.state = IDLE
        logger.warning("publish %d PROMOTED fleet-wide", m.publish_id)

    # -- rollback / quarantine ------------------------------------------

    def _rollback(self, step, reason):
        c = self._canary
        m = c["manifest"]
        for rid in sorted(c["fallbacks"]):
            eng = self.router.engines.get(rid)
            if eng is None:
                continue  # evicted: its factory replacement is clean
            try:
                eng.swap_weights(c["fallbacks"][rid])
                self.stats["swaps"] += 1
            except DEVICE_FAULTS:
                raise  # a card fault is not the publish's: it propagates
            except Exception:  # noqa: BLE001 - rollback is best-effort
                logger.error(
                    "rollback swap on replica %r failed; the replica "
                    "keeps the condemned weights until evicted", rid,
                    exc_info=True,
                )
        if c["held_out"] and c["rid"] in self.router.engines:
            self.router.ring.add(c["rid"])
        self._canary = None
        self.state = IDLE
        self._condemn(m.publish_id, step, reason)
        logger.error(
            "publish %d ROLLED BACK on the canary (%s); it never "
            "reached a second replica", m.publish_id, reason,
        )

    def _condemn(self, publish_id, step, reason):
        """Quarantine a publish id and trip the deploy breaker."""
        self.quarantined[publish_id] = reason
        if self.breaker.state == HALF_OPEN:
            self.breaker.fail(step)
        else:
            self.breaker.trip(step)
        self.stats["rollbacks"] += 1
        self.history.append({"publish_id": publish_id,
                             "outcome": "rollback", "reason": reason,
                             "step": step})

    # -- reporting ------------------------------------------------------

    def describe(self):
        return {
            "state": self.state,
            "current": None if self.current is None
            else self.current.publish_id,
            "previous": None if self.previous is None
            else self.previous.publish_id,
            "pending": None if self._pending is None
            else self._pending.publish_id,
            "quarantined": dict(self.quarantined),
            "breaker": self.breaker.describe(),
            "stats": dict(self.stats),
            "history": list(self.history),
        }
