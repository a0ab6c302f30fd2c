"""Seeded trace-replay load generator for the fleet tier (a copy of
``unicore_tpu/fleet/trace.py``: the same seed gives the same events,
field for field, in both packages; its :class:`Request` is the port's).

Production serve traffic is not a uniform request list: arrivals are
bursty (ON/OFF modulated Poisson), prompt lengths are heavy-tailed
(lognormal body over a shared session prefix), and a small set of hot
sessions dominates (Zipf).  This module generates exactly that shape as
a pure function of ONE seed, so a flood replays bit-identically: two
calls with the same seed produce the same arrival times, the same
session ids, the same token streams, the same sampling seeds: a
"p99 under trace 1106" number means something only if trace 1106 is the
same flood every run.

Shared-prefix population: sessions draw their prefix from a small pool
of "system prompts" (``prefix_pool``), so many sessions open with the
SAME tokens — the workload shape that makes consistent-hash affinity
(and the pool's prefix-cache dedup) pay off.

Replay is virtual-time: the fleet advances ``step_ms`` of virtual time
per router step and events are submitted when the virtual clock reaches
their arrival stamp.  Burst structure therefore shows up as real queue
depth without wall-clock sleeps, and the whole replay is deterministic.

**Scenario suite.**  Named traffic SHAPES, not just one flood: :func:`scenario_trace`
composes the seeded generator into ``diurnal`` (quiet -> peak ->
quiet), ``flash_crowd`` (a background trickle hit by a sudden burst of
brand-new sessions), ``session_churn`` (overlapping generations of
sessions — the affinity map keeps turning over), and ``heavy_tail``
(an adversarial mix: a short-prompt flood interleaved with rare huge
prompts).  Every scenario is a pure function of ONE seed — composition
uses :func:`shift_trace` / :func:`retag_sessions` /
:func:`merge_traces` with per-part sub-seeds derived via
``stable_hash``, so two runs of the same scenario replay the same
arrivals, the same sessions, the same token streams, and (downstream)
the same scaling decisions.
"""

import dataclasses
from typing import List

import numpy as np

from ..serve.scheduler import Request


@dataclasses.dataclass
class TraceEvent:
    """One arrival: ``at_ms`` is virtual time from trace start."""

    at_ms: float
    session: str
    request: Request


def generate_trace(seed, *, num_requests=48, sessions=8, prefix_pool=3,
                   prefix_len=(4, 10), body_len_lognorm=(1.6, 0.8),
                   body_len_clip=(1, 48), max_new_tokens=(4, 12),
                   mean_iat_ms=6.0, burst_factor=8.0,
                   mean_on_ms=40.0, mean_off_ms=120.0,
                   zipf_a=1.3, vocab=97, temperature=0.0, top_k=0,
                   deadline_ms=None) -> List[TraceEvent]:
    """Deterministic bursty trace: ``num_requests`` arrivals.

    - Arrivals: ON/OFF Poisson — ON phases arrive ``burst_factor``x
      faster than the ``mean_iat_ms`` average, OFF phases are quiet;
      phase durations are exponential (``mean_on_ms``/``mean_off_ms``).
    - Sessions: Zipf(``zipf_a``) over ``sessions`` ids, so a few hot
      sessions carry most requests.  Each session's prompts share that
      session's prefix, drawn from ``prefix_pool`` system prompts.
    - Prompt lengths: prefix + lognormal body clipped to
      ``body_len_clip`` — heavy-tailed, bounded.
    - Sampling seeds are derived per request from the trace seed, so a
      replayed request is reproducible from its Request alone.
    """
    rng = np.random.default_rng(int(seed))
    prefixes = [
        [int(t) for t in rng.integers(
            1, vocab, size=int(rng.integers(prefix_len[0],
                                            prefix_len[1] + 1)))]
        for _ in range(prefix_pool)
    ]
    session_prefix = [int(rng.integers(prefix_pool))
                      for _ in range(sessions)]

    events = []
    t = 0.0
    on = True
    phase_left = float(rng.exponential(mean_on_ms))
    # rates chosen so the long-run mean inter-arrival is ~mean_iat_ms
    on_iat = mean_iat_ms / burst_factor
    off_iat = mean_iat_ms * burst_factor
    for i in range(num_requests):
        iat = float(rng.exponential(on_iat if on else off_iat))
        while iat >= phase_left:
            t += phase_left
            iat -= phase_left
            on = not on
            phase_left = float(rng.exponential(
                mean_on_ms if on else mean_off_ms))
            iat = float(rng.exponential(on_iat if on else off_iat))
        phase_left -= iat
        t += iat
        s = min(int(rng.zipf(zipf_a)) - 1, sessions - 1)
        session = f"s{s}"
        body_n = int(np.clip(
            round(float(rng.lognormal(*body_len_lognorm))),
            body_len_clip[0], body_len_clip[1],
        ))
        body = [int(x) for x in rng.integers(1, vocab, size=body_n)]
        req = Request(
            prompt=list(prefixes[session_prefix[s]]) + body,
            max_new_tokens=int(rng.integers(max_new_tokens[0],
                                            max_new_tokens[1] + 1)),
            temperature=float(temperature), top_k=int(top_k),
            seed=int(stable_request_seed(seed, i)),
            request_id=f"t{int(seed)}-{i}.{session}",
            deadline_ms=deadline_ms,
        )
        events.append(TraceEvent(at_ms=round(t, 3), session=session,
                                 request=req))
    return events


def stable_request_seed(trace_seed, index):
    """Per-request sampling seed in the engine's int32 range, a pure
    function of (trace seed, arrival index)."""
    from .ring import stable_hash

    return stable_hash(f"trace{trace_seed}/req{index}") % (2 ** 31)


def clip_trace(events, max_context):
    """Drop events whose prompt cannot fit ``max_context`` (tiny test
    engines); returns the surviving events."""
    return [e for e in events if len(e.request.prompt) <= max_context]


# -- scenario suite ------------------------------------------


def shift_trace(events, offset_ms):
    """Shift every arrival by ``offset_ms`` of virtual time (requests
    are shared, stamps are new events)."""
    return [TraceEvent(at_ms=round(e.at_ms + float(offset_ms), 3),
                       session=e.session, request=e.request)
            for e in events]


def retag_sessions(events, prefix):
    """Prefix every session key: the SAME arrival structure over a
    brand-new session population (the affinity ring has never seen
    these keys — churn and flash-crowd scenarios are built from
    this)."""
    return [TraceEvent(at_ms=e.at_ms, session=f"{prefix}{e.session}",
                       request=e.request)
            for e in events]


def merge_traces(*parts):
    """Interleave trace parts into one arrival stream, ordered by
    (stamp, request id) — the same deterministic total order
    :func:`replay_trace` submits in.  Request ids must be unique
    across parts (distinct sub-seeds guarantee it)."""
    merged = [e for part in parts for e in part]
    merged.sort(key=lambda e: (e.at_ms, e.request.request_id))
    seen = set()
    for e in merged:
        if e.request.request_id in seen:
            raise ValueError(
                f"merge_traces: duplicate request id "
                f"{e.request.request_id!r} — compose parts from "
                "distinct sub-seeds"
            )
        seen.add(e.request.request_id)
    return merged


def _part_seed(seed, tag):
    """Deterministic sub-seed for one scenario component."""
    from .ring import stable_hash

    return stable_hash(f"scenario/{int(seed)}/{tag}") % (2 ** 31)


def _end_ms(events):
    return max((e.at_ms for e in events), default=0.0)


def _diurnal(seed, requests, kw):
    """Quiet -> peak -> quiet: the load curve a day of traffic draws.
    The peak carries ~60% of the arrivals at ~8x the trickle rate."""
    n_peak = max(1, int(requests * 0.6))
    n_edge = max(1, (requests - n_peak) // 2)
    quiet = dict(kw, mean_iat_ms=24.0, burst_factor=2.0)
    peak = dict(kw, mean_iat_ms=3.0, burst_factor=4.0)
    dawn = generate_trace(_part_seed(seed, "dawn"),
                          num_requests=n_edge, **quiet)
    noon = generate_trace(_part_seed(seed, "noon"),
                          num_requests=n_peak, **peak)
    dusk = generate_trace(_part_seed(seed, "dusk"),
                          num_requests=n_edge, **quiet)
    noon = shift_trace(noon, _end_ms(dawn) + 12.0)
    dusk = shift_trace(dusk, _end_ms(noon) + 12.0)
    return merge_traces(dawn, noon, dusk)


def _flash_crowd(seed, requests, kw):
    """A background trickle hit by a sudden crowd of NEW sessions: the
    crowd carries ~70% of the arrivals, lands at ~1/3 into the
    baseline, and arrives an order of magnitude faster."""
    n_crowd = max(1, int(requests * 0.7))
    n_base = max(1, requests - n_crowd)
    base = generate_trace(_part_seed(seed, "base"), num_requests=n_base,
                          **dict(kw, mean_iat_ms=18.0, burst_factor=2.0))
    crowd = generate_trace(_part_seed(seed, "crowd"),
                           num_requests=n_crowd,
                           **dict(kw, mean_iat_ms=1.0, burst_factor=2.0,
                                  mean_on_ms=120.0, mean_off_ms=10.0,
                                  sessions=max(4, kw.get("sessions", 8))))
    crowd = retag_sessions(crowd, "crowd.")
    crowd = shift_trace(crowd, _end_ms(base) / 3.0)
    return merge_traces(base, crowd)


def _session_churn(seed, requests, kw):
    """Overlapping GENERATIONS of sessions: each generation is a fresh
    session population that arrives while the previous one is still
    tailing off — the affinity map keeps turning over instead of
    settling."""
    n_gen = max(1, requests // 3)
    gens = []
    offset = 0.0
    for g in range(3):
        part = generate_trace(
            _part_seed(seed, f"gen{g}"), num_requests=n_gen,
            **dict(kw, mean_iat_ms=6.0, burst_factor=3.0),
        )
        part = retag_sessions(part, f"g{g}.")
        part = shift_trace(part, offset)
        # the next generation starts before this one ends (overlap)
        offset = _end_ms(part) * 0.7
        gens.append(part)
    return merge_traces(*gens)


def _heavy_tail(seed, requests, kw):
    """Adversarial prompt mix: a flood of short prompts interleaved
    with rare HUGE prompts (the lognormal tail turned all the way up)
    — the shape that starves a naive scheduler and stresses admission
    under scale events."""
    n_tail = max(1, requests // 6)
    n_flood = max(1, requests - n_tail)
    flood = generate_trace(
        _part_seed(seed, "flood"), num_requests=n_flood,
        **dict(kw, mean_iat_ms=3.0, burst_factor=3.0,
               body_len_lognorm=(1.0, 0.4), body_len_clip=(1, 8)),
    )
    tail = generate_trace(
        _part_seed(seed, "tail"), num_requests=n_tail,
        **dict(kw, mean_iat_ms=16.0, burst_factor=1.5,
               body_len_lognorm=(2.8, 0.9), body_len_clip=(12, 48)),
    )
    tail = retag_sessions(tail, "tail.")
    return merge_traces(flood, tail)


_SCENARIO_BUILDERS = {
    "diurnal": _diurnal,
    "flash_crowd": _flash_crowd,
    "session_churn": _session_churn,
    "heavy_tail": _heavy_tail,
}

SCENARIOS = tuple(sorted(_SCENARIO_BUILDERS))


def scenario_trace(name, seed, *, num_requests=48, **overrides):
    """One named traffic scenario as a deterministic event list.

    ``name`` is one of :data:`SCENARIOS`; ``num_requests`` is the
    TOTAL arrival count across all components; ``overrides`` pass
    through to every :func:`generate_trace` component (``vocab``,
    ``deadline_ms``, ``max_new_tokens``, ... — component-specific
    shape knobs like ``mean_iat_ms`` win over overrides where the
    scenario defines them)."""
    try:
        builder = _SCENARIO_BUILDERS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}: pick one of {SCENARIOS}"
        ) from None
    return builder(int(seed), int(num_requests), dict(overrides))


def replay_trace(router, events, *, step_ms=2.0,
                 on_step=None, max_steps=200000) -> int:
    """Drive ``events`` through a :class:`~unicore_tpu_torch.fleet.
    router.FleetRouter` on a virtual clock: each fleet step advances
    ``step_ms`` of virtual time, and events are submitted once the
    clock reaches their stamp.  ``on_step(step_index, router)`` is the
    mid-replay hook (a rolling restart or a kill can be triggered
    from it).  Returns the number of fleet steps taken."""
    pending = sorted(events, key=lambda e: (e.at_ms, e.request.request_id))
    now = 0.0
    steps = 0
    i = 0
    while i < len(pending) or router.has_work():
        while i < len(pending) and pending[i].at_ms <= now:
            ev = pending[i]
            router.submit(ev.request, session_key=ev.session)
            i += 1
        if i < len(pending) and not router.has_work():
            # fleet idle before the next burst: jump the virtual clock
            now = max(now, pending[i].at_ms)
            continue
        router.step()
        if on_step is not None:
            on_step(steps, router)
        now += step_ms
        steps += 1
        if steps >= max_steps:
            raise RuntimeError(
                f"trace replay exceeded {max_steps} fleet steps with "
                f"{len(pending) - i} arrivals pending — wedged fleet?"
            )
    router.collect()
    return steps


__all__ = ["TraceEvent", "generate_trace", "replay_trace", "clip_trace",
           "stable_request_seed", "scenario_trace", "shift_trace",
           "retag_sessions", "merge_traces", "SCENARIOS"]
