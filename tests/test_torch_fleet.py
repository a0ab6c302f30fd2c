"""The port's fleet tier (``unicore_tpu_torch/fleet``) against the JAX
package's (``unicore_tpu/fleet``), and the fleet-facing surface of the
port's serve engine.

Exact, against the JAX package:
- ``HashRing`` assignments of seeded keys, through a leave and a rejoin;
- ``generate_trace`` and every ``scenario_trace``, event for event, at
  two seeds;
- ``CircuitBreaker`` and ``ReplicaHealth`` state sequences under one
  event list;
- ``load_snapshot`` keys and value types;
- a ``FleetRouter`` replay of one seeded trace over three replicas of
  the tiny LM (the weights of ``tests/test_fleet.py``'s, both packages),
  one replica killed and one wedged mid-replay, both replaced through
  the circuit breaker's canary: every assignment the router records,
  each request's finish reason and greedy tokens, and ``fleet_report()``
  (all but the measured step times).  Every token
  equals the port's solo decode, and every compared step's top-2 logit
  gap exceeds 1e-3 (the serve tests' fp32-tie rule), so a flipped
  argmax reads as a failure, not as a tie;
- an autoscaled replay of the seeded ``flash_crowd`` and ``diurnal``
  scenarios over two replicas (a scale-up through the canary, a
  scale-down through the zero-drop drain): the decision log,
  ``fleet_report()["autoscale"]`` and ``["retired"]``, the router's
  counters and every request's finish reason and tokens; and the
  autoscale report's keys.

On the port alone: ``--fleet`` serves the CLI demo on the CPU with the
solo path's tokens (``--progress-file`` a line a decode step), with
``--autoscale`` too, the split dispatch of ``unified=False`` the
unified tokens, a device fault in a replica's step goes past the router,
an evicted or retired replica's watchdog stops and its engine is
collected, a scale-up boots off the ring through its canary, a failed
boot counts against the boot budget and is not retried by the breaker,
and the autoscaler's envelope and the CLI's flags are validated.
"""

import dataclasses
import gc
import json
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import one_thread_module  # noqa: F401
from unicore_tpu_torch.examples.lm.model import TransformerLMModel, solo_greedy
from unicore_tpu_torch.fleet import (SCENARIOS, CircuitBreaker,
                                     FleetAutoscaler, FleetRouter, HashRing,
                                     ReplicaHealth, clip_trace,
                                     generate_trace, replay_trace,
                                     scenario_trace)
from unicore_tpu_torch.ops.build import KernelError
from unicore_tpu_torch.serve.engine import ServeEngine
from unicore_tpu_torch.serve.scheduler import Request

V, D, H, F, L = 29, 32, 4, 64, 2
POOL = dict(num_pages=24, page_size=4, max_batch=4)
MAX_CONTEXT = (POOL["num_pages"] - 1) * POOL["page_size"]


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def make_pair():
    """(flax model, flax params, port model): the LM of
    ``tests/test_fleet.py`` with the same weights in both packages."""
    from examples.lm.model import TransformerLMModel as FlaxLM

    fmodel = FlaxLM(
        vocab_size=V, padding_idx=0, decoder_layers=L, decoder_embed_dim=D,
        decoder_ffn_embed_dim=F, decoder_attention_heads=H, max_seq_len=64,
        emb_dropout=0.0, dropout=0.0, attention_dropout=0.0,
        activation_dropout=0.0, rel_pos=False, abs_pos=False, rotary=True,
    )
    params = fmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    model = TransformerLMModel(
        vocab_size=V, padding_idx=0, decoder_layers=L, decoder_embed_dim=D,
        decoder_ffn_embed_dim=F, decoder_attention_heads=H, max_seq_len=64,
    )
    model.load_flax_params(params)
    return fmodel, params, model.eval()


class Clock:
    """One virtual clock for every engine of a replay (both packages)."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


_JAX_STEPS = {}


def jax_engines(pair, n, clock, **kw):
    """``n`` JAX engines sharing one jitted-step cache: the steps close
    over the same model and pool layout, so each width compiles once."""
    from unicore_tpu.serve.engine import ServeEngine as FlaxEngine

    fmodel, params, _ = pair
    engines = {f"r{i}": FlaxEngine(fmodel, params, clock=clock,
                                   **{**POOL, **kw}) for i in range(n)}
    for eng in engines.values():
        eng._step_fns = _JAX_STEPS.setdefault(id(fmodel), {})
    return engines


def port_engines(pair, n, clock, **kw):
    return {f"r{i}": ServeEngine(pair[2], device="cpu", clock=clock,
                                 **{**POOL, **kw}) for i in range(n)}


# -- ring, trace, health ---------------------------------------------------


def test_ring_assignments_equal_jax():
    from unicore_tpu.fleet.ring import HashRing as FlaxRing

    keys = [f"user-{k}" for k in range(300)]
    rings = [cls([f"r{i}" for i in range(4)], vnodes=64)
             for cls in (HashRing, FlaxRing)]
    for change in (None, ("discard", "r1"), ("add", "r1"),
                   ("remove", "r3")):
        if change is not None:
            for ring in rings:
                getattr(ring, change[0])(change[1])
        got, want = ([ring.lookup(k) for k in keys] for ring in rings)
        assert got == want, change
        assert rings[0].members() == rings[1].members()


def _events(events):
    return [(e.at_ms, e.session, dataclasses.asdict(e.request))
            for e in events]


@pytest.mark.parametrize("seed", [0, 7])
def test_traces_equal_jax_event_for_event(seed):
    from unicore_tpu.fleet import trace as flax_trace

    kw = dict(num_requests=40, sessions=6, vocab=V, deadline_ms=500.0)
    assert _events(generate_trace(seed, **kw)) == _events(
        flax_trace.generate_trace(seed, **kw))
    assert SCENARIOS == flax_trace.SCENARIOS
    for name in SCENARIOS:
        got = scenario_trace(name, seed, num_requests=30, vocab=V)
        assert _events(got) == _events(flax_trace.scenario_trace(
            name, seed, num_requests=30, vocab=V)), name
    assert _events(clip_trace(generate_trace(seed, **kw), 12)) == _events(
        flax_trace.clip_trace(flax_trace.generate_trace(seed, **kw), 12))


def _health_script(health, breaker):
    """One event list through a ReplicaHealth and a CircuitBreaker: the
    state after every event, and the final descriptions."""
    out = []
    snap = {"last_progress": 0, "host_faults": 0, "waiting": 1,
            "running": 1, "free_pages": 10, "prefix_hits": 0}
    rng = np.random.default_rng(3)
    for step in range(1, 60):
        r = rng.random()
        if r < 0.3:
            snap = dict(snap, last_progress=snap["last_progress"] + 1)
        elif r < 0.4:
            snap = dict(snap, host_faults=snap["host_faults"] + 1)
        out.append(health.observe("r0", snap, r < 0.9, step=step))
        if step in (20, 41):
            health.reset("r0")
    out.append(health.record_exception("r1", RuntimeError("boom"), step=60))
    out.append(health.describe("r0"))
    out.append(health.describe("r1"))
    for step, op in [(10, "trip"), (11, "ready"), (13, "ready"),
                     (13, "probe"), (14, "fail"), (15, "quarantined"),
                     (17, "ready"), (17, "probe"), (18, "fail"),
                     (19, "quarantined"), (40, "ready"), (90, "ready"),
                     (90, "probe"), (91, "succeed"), (92, "arm"),
                     (92, "ready")]:
        try:
            got = getattr(breaker, op)(step)
        except RuntimeError as e:  # a probe while not ready, ...
            got = str(e)
        out.append((op, got, breaker.state, breaker.describe()))
    return out


def test_health_and_breaker_sequences_equal_jax():
    from unicore_tpu.fleet import health as flax_health

    kw = dict(suspect_steps=2, dead_steps=4, fault_budget=2, fault_window=6)
    bkw = dict(cooldown_steps=2, flap_limit=2, flap_window=30)
    got = _health_script(ReplicaHealth(**kw), CircuitBreaker(**bkw))
    want = _health_script(flax_health.ReplicaHealth(**kw),
                          flax_health.CircuitBreaker(**bkw))
    assert got == want
    assert {"healthy", "suspect", "dead"} <= set(
        s for s in got if isinstance(s, str))


def test_load_snapshot_keys_and_types_equal_jax(pair):
    from unicore_tpu.serve.scheduler import Request as FlaxRequest

    clock = Clock()
    snaps = []
    for engines, req in ((port_engines(pair, 1, clock), Request),
                         (jax_engines(pair, 1, clock), FlaxRequest)):
        eng = engines["r0"]
        before = eng.load_snapshot()
        eng.generate([req(prompt=[3, 4, 5], max_new_tokens=3,
                          request_id="a")])
        snaps.append((before, eng.load_snapshot()))
    for got, want in zip(*snaps):
        assert list(got) == list(want)
        assert {k: type(v) for k, v in got.items()} == \
            {k: type(v) for k, v in want.items()}
        assert {k: v for k, v in got.items() if k != "step_ms"} == \
            {k: v for k, v in want.items() if k != "step_ms"}


# -- the replay: a kill and a wedge ------------------------------------------


def _replay(pair, port):
    """Three replicas, a seeded trace; replica r0 crashes at fleet step 4
    and r1 wedges at fleet step 9, and a factory replaces each through
    the breaker's canary.  Returns the steps, assignments, results,
    report and events."""
    if port:
        from unicore_tpu_torch.fleet import health, router, trace
        engines = port_engines
        req_type = Request
    else:
        from unicore_tpu.fleet import health, router, trace
        from unicore_tpu.serve.scheduler import Request as req_type
        engines = jax_engines
    clock = Clock()
    fleet = router.FleetRouter(
        engines(pair, 3, clock), max_failovers=2,
        factory=lambda rid: engines(pair, 1, clock)["r0"],
        health=health.ReplicaHealth(suspect_steps=2, dead_steps=4),
        breaker=lambda rid: health.CircuitBreaker(cooldown_steps=3))
    assigned = []
    record = fleet._record_assignment

    def logged(request_id, session, choice):
        assigned.append((request_id, session, choice))
        record(request_id, session, choice)

    fleet._record_assignment = logged
    events = clip_trace(generate_trace(
        5, num_requests=18, sessions=5, vocab=V, max_new_tokens=(4, 9),
        body_len_clip=(1, 14), mean_iat_ms=3.0), MAX_CONTEXT)
    for e in events:  # the package's own Request type
        e.request = req_type(**dataclasses.asdict(e.request))

    def on_step(step, fleet):
        clock.now += 0.002
        if step == 4:
            def boom():
                raise RuntimeError("chaos: replica killed mid-traffic")
            fleet.engines["r0"].serve_step = boom
        if step == 9:
            fleet.engines["r1"].serve_step = lambda: True

    steps = trace.replay_trace(fleet, events, on_step=on_step)
    results = {rid: (r.finish_reason, list(r.tokens))
               for rid, r in fleet.results().items()}
    report = fleet.fleet_report()
    for snap in report["per_replica"].values():
        snap.pop("step_ms")
    return steps, assigned, results, report, events


@pytest.fixture(scope="module")
def replays(pair):
    return _replay(pair, port=True), _replay(pair, port=False)


def test_replay_with_kill_and_wedge_equals_jax(replays):
    (steps, assigned, results, report, _), want = replays
    assert steps == want[0]
    assert assigned == want[1]
    assert results == want[2]
    assert report == want[3]
    assert report["router"]["replicas_lost"] == 2
    assert report["router"]["failovers"] >= 1
    assert "crash" in report["lost"]["r0"]["reason"]
    assert "wedged" in report["lost"]["r1"]["reason"]
    assert report["router"]["rejoins"] == 2


def test_replay_tokens_are_solo_greedy(pair, replays):
    (_, _, results, _, events), _ = replays
    assert len(results) == len(events)
    for e in events:
        reason, tokens = results[e.request.request_id]
        assert reason == "length", e.request.request_id
        solo, margins = solo_greedy(pair[2], e.request.prompt,
                                    e.request.max_new_tokens)
        assert tokens == solo, e.request.request_id
        assert min(margins) > 1e-3, (e.request.request_id, margins)


# -- the port alone ------------------------------------------------------------


def test_device_fault_passes_the_router(pair):
    """A kernel fault in a replica's step is the card's, not the
    replica's: it leaves the router instead of evicting the replica."""
    fleet = FleetRouter(port_engines(pair, 2, Clock()))
    fleet.submit(Request(prompt=[3, 4], max_new_tokens=2, request_id="a"))

    def fault():
        raise KernelError("paged_attention: launch failed")

    fleet.engines["r0"].serve_step = fault
    with pytest.raises(KernelError):
        fleet.step()
    assert sorted(fleet.engines) == ["r0", "r1"]
    assert fleet.stats["replicas_lost"] == 0


def test_evicted_replica_is_freed(pair):
    """An evicted replica's watchdog stops and nothing keeps the engine
    (its KV pool and, after a swap, its own parameters) alive; the
    router's ``close`` stops the survivors' watchdogs."""
    fleet = FleetRouter(port_engines(pair, 2, Clock(), step_timeout=30))
    for i in range(4):
        fleet.submit(Request(prompt=[3, 4 + i], max_new_tokens=6,
                             request_id=f"q{i}"), session_key=f"s{i}")
    fleet.step()
    dogs = {rid: e.watchdog for rid, e in fleet.engines.items()}
    assert all(d._thread.is_alive() for d in dogs.values())
    gone = weakref.ref(fleet.engines["r0"])

    def boom():
        raise RuntimeError("chaos: replica killed")

    fleet.engines["r0"].serve_step = boom
    fleet.run_until_complete()
    assert "r0" not in fleet.engines and fleet.stats["replicas_lost"] == 1
    assert not dogs["r0"]._thread.is_alive()
    gc.collect()
    assert gone() is None
    assert {r.finish_reason for r in fleet.results().values()} == {"length"}
    fleet.close()
    assert not dogs["r1"]._thread.is_alive()


# -- elastic scaling --------------------------------------------------------

# the knobs of tests/test_fleet.py's autoscaled replay: a virtual step of
# 2 ms, so the policy's pressure is a function of the queues alone
AUTOSCALE = dict(min_replicas=1, max_replicas=3, high_watermark_ms=12.0,
                 low_watermark_ms=1.0, hysteresis_steps=2, cooldown_steps=4,
                 step_time_ms=2.0)


def _autoscale_run(pair, port, scenario):
    """Two replicas under ``AUTOSCALE`` replay the seeded ``scenario``
    (18 requests), then run out.  Returns the decision log, the
    autoscale and retired reports, the router's counters and each
    request's (finish reason, tokens)."""
    if port:
        from unicore_tpu_torch.fleet import autoscaler, router, trace
        engines, req_type = port_engines, Request
    else:
        from unicore_tpu.fleet import autoscaler, router, trace
        from unicore_tpu.serve.scheduler import Request as req_type
        engines = jax_engines
    clock = Clock()
    fleet = router.FleetRouter(
        engines(pair, 2, clock),
        factory=lambda rid: engines(pair, 1, clock)["r0"])
    scaler = fleet.attach_autoscaler(
        autoscaler.FleetAutoscaler(fleet, **AUTOSCALE))
    events = clip_trace(scenario_trace(scenario, 5, num_requests=18,
                                       vocab=V, body_len_clip=(1, 16)),
                        MAX_CONTEXT)
    for e in events:
        e.request = req_type(**dataclasses.asdict(e.request))

    def on_step(step, fleet):
        clock.now += 0.002

    trace.replay_trace(fleet, events, on_step=on_step)
    fleet.run_until_complete()
    report = fleet.fleet_report()
    return (scaler.decisions, report["autoscale"], report["retired"],
            report["router"],
            {rid: (r.finish_reason, list(r.tokens))
             for rid, r in fleet.results().items()}, events)


@pytest.fixture(scope="module")
def autoscaled(pair):
    return {scenario: (_autoscale_run(pair, True, scenario),
                       _autoscale_run(pair, False, scenario))
            for scenario in ("flash_crowd", "diurnal")}


@pytest.mark.parametrize("scenario", ["flash_crowd", "diurnal"])
def test_autoscaled_replay_equals_jax(pair, autoscaled, scenario):
    """Event for event the JAX fleet's: the decision log (a scale-up,
    its join, a scale-down), the autoscale report, the retirement
    record (zero shed, the pool idle), the router's counters and every
    request's tokens, which are the solo decode's; a second port replay
    decides the same."""
    got, want = autoscaled[scenario]
    decisions, auto, retired, router, results, events = got
    assert decisions == want[0]
    assert auto == want[1]
    assert retired == want[2]
    assert router == want[3]
    assert results == want[4]
    assert [d["action"] for d in decisions][:2] == ["scale_up", "joined"]
    assert "scale_down" in [d["action"] for d in decisions]
    assert router["scale_ups"] == 1 and router["retired"] == 1
    for rec in retired.values():
        assert rec["died"] is False and rec["pool_idle"] is True
        assert rec["drain"]["shed"] == 0 and rec["drain"]["expired"] == 0
    assert len(results) == len(events)
    for e in events:
        reason, tokens = results[e.request.request_id]
        assert reason in ("eos", "length"), e.request.request_id
        solo, _ = solo_greedy(pair[2], e.request.prompt,
                              e.request.max_new_tokens)
        assert tokens == solo[:len(tokens)], e.request.request_id
    again = _autoscale_run(pair, True, scenario)
    assert again[:5] == got[:5]


def test_autoscale_report_keys_equal_jax(pair):
    """``fleet_report()``'s autoscale keys are the JAX report's, None
    without an autoscaler, and the retirement keys start empty."""
    from unicore_tpu.fleet import FleetRouter as FlaxRouter
    from unicore_tpu.fleet.autoscaler import FleetAutoscaler as FlaxScaler

    reports = []
    for router, scaler, engines in (
            (FleetRouter, FleetAutoscaler, port_engines),
            (FlaxRouter, FlaxScaler, jax_engines)):
        fleet = router(engines(pair, 2, Clock()))
        rep = fleet.fleet_report()
        assert rep["autoscale"] is None
        assert rep["retiring"] == [] and rep["retired"] == {}
        fleet.attach_autoscaler(scaler(fleet, min_replicas=1,
                                       max_replicas=3))
        reports.append(fleet.fleet_report())
    got, want = reports
    assert list(got) == list(want)
    assert got["autoscale"] == want["autoscale"]
    assert got["autoscale"]["serving"] == 2
    assert got["autoscale"]["decisions"] == []


def test_scale_up_boots_through_canary_off_ring(pair):
    clock = Clock()
    fleet = FleetRouter(port_engines(pair, 2, clock),
                        factory=lambda rid: port_engines(pair, 1,
                                                         clock)["r0"])
    assert fleet.scale_up("a0") is True
    # OFF-RING while probing: no traffic can route to the canary slot
    assert "a0" in fleet._probation and "a0" not in fleet.engines
    assert "a0" not in fleet.ring.members()
    for _ in range(fleet.probe_budget_steps + 2):
        fleet.step()
        if "a0" in fleet.engines:
            break
    assert "a0" in fleet.engines and "a0" in fleet.ring.members()
    assert fleet.stats["scale_ups"] == 1 and fleet.stats["rejoins"] == 1
    with pytest.raises(ValueError):
        fleet.scale_up("a0")  # a joined slot's id is taken
    with pytest.raises(RuntimeError, match="factory"):
        FleetRouter(port_engines(pair, 1, clock)).scale_up("a1")


def test_failed_boot_is_the_autoscalers_to_retry(pair):
    """A boot whose factory fails never takes traffic, counts against
    the boot budget, and the breaker's tick does not retry the slot: the
    exhausted budget stops the policy booting."""
    def broken(rid):
        raise RuntimeError("chaos: factory down")

    fleet = FleetRouter(port_engines(pair, 1, Clock()), factory=broken)
    scaler = fleet.attach_autoscaler(FleetAutoscaler(
        fleet, max_replicas=3, high_watermark_ms=0.5, low_watermark_ms=0.1,
        hysteresis_steps=1, cooldown_steps=0, boot_budget=2,
        step_time_ms=2.0))
    for i in range(3):
        fleet.submit(Request(prompt=[3, 4 + i], max_new_tokens=8,
                             request_id=f"q{i}"))
    fleet.run_until_complete()
    assert [d["action"] for d in scaler.decisions] == ["boot_failed"] * 2
    assert scaler.describe()["boot_failures"] == 2
    assert sorted(fleet.engines) == ["r0"] and not fleet._probation
    assert fleet.stats["scale_ups"] == 0
    assert {r.finish_reason for r in fleet.results().values()} == {"length"}


def test_retire_replica_zero_drop_under_load_frees_it(pair):
    """A retirement under load drops nothing: every request finishes
    with the solo decode's tokens, the victim's pool ends idle, its
    child is marked retired, and its watchdog stops and its engine is
    collected (the JAX router keeps retired engines)."""
    fleet = FleetRouter(port_engines(pair, 3, Clock(), step_timeout=30))
    reqs = [Request(prompt=[1 + (i % 7), 2, 3], max_new_tokens=4,
                    seed=i, request_id=f"q{i}") for i in range(9)]
    for i, req in enumerate(reqs):
        fleet.submit(req, session_key=f"s{i % 4}")
    fleet.step()
    victim = sorted(fleet.engines)[0]
    dog = fleet.engines[victim].watchdog
    child = fleet._children[victim]
    gone = weakref.ref(fleet.engines[victim])
    fleet.retire_replica(victim)
    assert victim not in fleet.ring.members()
    assert fleet.fleet_report()["retiring"] == [victim]
    with pytest.raises(ValueError, match="already retiring"):
        fleet.retire_replica(victim)
    fleet.run_until_complete()
    results = fleet.results()
    assert len(results) == len(reqs)
    for req in reqs:
        res = results[req.request_id]
        assert res.finish_reason in ("eos", "length"), res
        solo, _ = solo_greedy(pair[2], req.prompt, req.max_new_tokens)
        assert res.tokens == solo, req.request_id
    assert victim not in fleet.engines and fleet.stats["retired"] == 1
    rec = fleet.fleet_report()["retired"][victim]
    assert rec["died"] is False and rec["pool_idle"] is True
    assert rec["drain"]["shed"] == 0 and rec["drain"]["expired"] == 0
    assert child.retired and child.requested
    child.clear()
    assert child.requested  # a retired slot never re-opens
    assert not dog._thread.is_alive()
    gc.collect()
    assert gone() is None
    fleet.close()


def test_autoscaler_envelope_validation(pair):
    fleet = FleetRouter(port_engines(pair, 2, Clock()))
    with pytest.raises(ValueError):
        FleetAutoscaler(fleet, min_replicas=0)
    with pytest.raises(ValueError):
        FleetAutoscaler(fleet, min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        FleetAutoscaler(fleet, high_watermark_ms=4.0, low_watermark_ms=4.0)
    with pytest.raises(ValueError):
        FleetAutoscaler(fleet, hysteresis_steps=0)


def test_serve_cli_autoscale_flag_validation():
    from unicore_tpu_torch.serve.cli import main

    with pytest.raises(SystemExit, match="needs --fleet"):
        main(["--demo", "--device", "cpu", "--autoscale",
              "--num-requests", "2"])
    with pytest.raises(SystemExit, match="envelope is empty"):
        main(["--demo", "--device", "cpu", "--fleet", "--autoscale",
              "--min-replicas", "3", "--max-replicas", "2",
              "--num-requests", "2"])


def test_split_dispatch_serves_the_unified_tokens(pair):
    """``unified=False`` (the A/B baseline) dispatches prefill rows and
    decode rows apart: more dispatches, the same tokens."""
    reqs = [Request(prompt=list(range(3, 3 + n)), max_new_tokens=5,
                    request_id=f"u{n}") for n in (3, 9, 14)]
    runs = {}
    for unified in (True, False):
        eng = port_engines(pair, 1, Clock(), unified=unified,
                           prefill_chunk=4)["r0"]
        runs[unified] = ([r.tokens for r in eng.generate(
            [dataclasses.replace(r) for r in reqs])],
            eng.stats["ragged_dispatches"])
    assert runs[False][0] == runs[True][0]
    assert runs[False][1] > runs[True][1]


def test_cli_fleet_demo_serves_the_solo_tokens(tmp_path):
    from unicore_tpu_torch.serve.cli import main

    argv = ["--demo", "--device", "cpu", "--num-requests", "6",
            "--max-new-tokens", "6", "--page-size", "4", "--num-pages", "24",
            "--max-batch", "4"]
    reports = {}
    for mode, extra in (("solo", []), ("fleet", [
            "--fleet", "--replicas", "2", "--sessions", "3",
            "--step-timeout", "60", "--progress-file",
            str(tmp_path / "progress")]), ("autoscale", [
            "--fleet", "--replicas", "1", "--autoscale", "--min-replicas",
            "1", "--max-replicas", "3", "--scale-cooldown-steps", "4"])):
        out = tmp_path / f"{mode}.json"
        assert main(argv + extra + ["--json", str(out)]) == 0
        reports[mode] = json.loads(out.read_text())
    fleet = reports["fleet"]
    assert fleet["pool_clean"] is True
    assert sorted(fleet["replicas"]) == ["r0", "r1"]
    assert all(r["drain"]["pool_idle"] for r in fleet["replicas"].values())
    assert fleet["fleet"]["router"]["routed"] == 6
    assert fleet["fleet"]["autoscale"] is None
    assert {h["watchdog"]["fired"]
            for h in fleet["fleet"]["health"].values()} == {False}
    # each replica appends its decode-step count after every decode step
    lines = (tmp_path / "progress").read_text().split()
    assert len(lines) == fleet["fleet"]["aggregate"]["decode_steps"] > 0
    assert [(r["request_id"], r["tokens"], r["finish_reason"])
            for r in fleet["results"]] == [
        (r["request_id"], r["tokens"], r["finish_reason"])
        for r in reports["solo"]["results"]]
    auto = reports["autoscale"]
    assert auto["pool_clean"] is True
    assert auto["fleet"]["autoscale"]["min_replicas"] == 1
    assert auto["fleet"]["autoscale"]["max_replicas"] == 3
    assert [(r["request_id"], r["tokens"], r["finish_reason"])
            for r in auto["results"]] == [
        (r["request_id"], r["tokens"], r["finish_reason"])
        for r in reports["solo"]["results"]]
