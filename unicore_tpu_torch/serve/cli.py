"""``python -m unicore_tpu_torch.serve``: offline batch generation through
the port's continuous-batching engine (counterpart of the solo path of
``unicore_tpu/serve/cli.py``).

Two sources of model + prompts:

- ``--checkpoint ckpt.pt --dict dict.txt --prompts FILE`` serves a
  trained ``transformer_lm`` checkpoint of either package (the model
  rebuilt from the file's ``args``, its fp32 master params:
  :func:`~unicore_tpu_torch.deploy.load_serve_model`); one request per
  line of ``FILE``, whitespace-separated token ids;
- ``--demo`` serves a tiny model with seeded random weights on random
  prompts of mixed lengths — the zero-setup smoke path.

Decoding is greedy unless ``--temperature > 0``: then seeded sampling
(``--top-k`` to filter), request ``i`` keyed by seed ``--seed + i``, the
JAX CLI's tokens for the same flags.  ``--device`` picks the device
(default ``cuda``; without a card the run fails rather than falling back
to the CPU).  ``--step-timeout`` arms each engine's step watchdog.

``--fleet`` routes the requests through a
:class:`~unicore_tpu_torch.fleet.router.FleetRouter` over ``--replicas``
in-process engines that share the model (session keys ``s{i mod
--sessions}``), with failover and circuit-breaker rejoin; with
``--publish-dir`` a :class:`~unicore_tpu_torch.deploy.rollout.
RolloutController` watches the directory and rolls each verified
manifest out canary-first.  ``--autoscale`` attaches a
:class:`~unicore_tpu_torch.fleet.autoscaler.FleetAutoscaler` that boots
replicas off-ring through the canary under load and retires the
least-loaded one through the zero-drop drain when idle, between
``--min-replicas`` and ``--max-replicas``, ``--scale-cooldown-steps``
fleet steps apart in each direction.

Output: one JSON object (``--json FILE`` or stdout) with per-request
generated ids, finish reasons, TTFT, and the engine's aggregate stats
(under ``--fleet``: per-replica stats and drain records, and the
router's ``fleet`` report).
"""

import argparse
import json
import logging
import signal
import sys

import numpy as np

from ..resilience.preemption import GracefulShutdown
from .engine import ServeEngine
from .scheduler import DEFAULT_REQUEST_RETRIES, Request

logger = logging.getLogger("unicore_tpu_torch.serve.cli")


def make_parser():
    p = argparse.ArgumentParser(
        "unicore_tpu_torch.serve",
        description="offline batch generation via the paged-KV "
                    "continuous-batching engine (PyTorch/CUDA port)",
    )
    src = p.add_argument_group("model source")
    src.add_argument("--checkpoint", help="framework checkpoint (.pt)")
    src.add_argument("--dict", dest="dict_path",
                     help="dict.txt the model was trained with")
    src.add_argument("--demo", action="store_true",
                     help="tiny random model + random prompts (smoke)")
    src.add_argument("--device", default="cuda",
                     help="torch device to serve on (default: cuda)")
    req = p.add_argument_group("requests")
    req.add_argument("--prompts",
                     help="file of whitespace-separated token-id lines")
    req.add_argument("--num-requests", type=int, default=4,
                     help="demo mode: how many random requests")
    req.add_argument("--prompt-len-range", default="3,17",
                     help="demo mode: 'lo,hi' prompt lengths")
    req.add_argument("--max-new-tokens", type=int, default=16)
    req.add_argument("--temperature", type=float, default=0.0,
                     help="0 = greedy; > 0 samples, seeded per request")
    req.add_argument("--top-k", type=int, default=0,
                     help="sample among the k largest logits (0 = all)")
    req.add_argument("--seed", type=int, default=1,
                     help="request i samples with seed --seed + i")
    eng = p.add_argument_group("engine")
    eng.add_argument("--page-size", type=int, default=16)
    eng.add_argument("--num-pages", type=int, default=64)
    eng.add_argument("--max-batch", type=int, default=8)
    eng.add_argument("--prefill-token-budget", type=int, default=512)
    eng.add_argument("--prefill-chunk", type=int, default=0,
                     help="ragged-step prefill chunk width (0 = default)")
    eng.add_argument("--prefix-cache", choices=("on", "off"),
                     default="on",
                     help="shared-prefix KV page dedup (default: on)")
    flt = p.add_argument_group("fleet")
    flt.add_argument("--fleet", action="store_true",
                     help="route through a FleetRouter over --replicas "
                          "in-process engines (consistent-hash session "
                          "affinity + SLO-aware overflow) instead of one "
                          "engine; the report carries per-replica stats, "
                          "drain records and the fleet aggregate")
    flt.add_argument("--replicas", type=int, default=2,
                     help="fleet mode: replica count (default: 2)")
    flt.add_argument("--sessions", type=int, default=4,
                     help="fleet mode: requests are spread over this many "
                          "session keys (affinity groups)")
    flt.add_argument("--max-failovers", type=int, default=2,
                     help="how many replica deaths one request may survive "
                          "before it finishes 'replica_lost' (default: 2)")
    flt.add_argument("--suspect-steps", type=int, default=4,
                     help="fleet steps of frozen progress before a replica "
                          "is suspect (default: 4)")
    flt.add_argument("--progress-budget-steps", type=int, default=8,
                     help="fleet steps of frozen progress before a wedged "
                          "replica is declared dead and evicted "
                          "(default: 8)")
    flt.add_argument("--breaker-cooldown", type=int, default=8,
                     help="fleet steps after an eviction before a "
                          "replacement may probe for rejoin (default: 8)")
    flt.add_argument("--flap-limit", type=int, default=3,
                     help="trips inside the flap window that hold a replica "
                          "slot quarantined (default: 3)")
    flt.add_argument("--autoscale", action="store_true",
                     help="fleet mode: attach the deterministic elastic "
                          "scaling policy: scale-up boots replicas "
                          "off-ring through the breaker's canary, "
                          "scale-down retires the least-loaded replica "
                          "through the zero-drop drain")
    flt.add_argument("--min-replicas", type=int, default=1,
                     help="autoscale: never retire below this many "
                          "serving replicas (default: 1)")
    flt.add_argument("--max-replicas", type=int, default=4,
                     help="autoscale: never boot above this many "
                          "serving+booting replicas; at saturation the "
                          "engines shed deterministically instead of "
                          "growing (default: 4)")
    flt.add_argument("--scale-cooldown-steps", type=int, default=16,
                     help="autoscale: per-direction refractory period "
                          "between scaling decisions, in fleet steps "
                          "(default: 16)")
    flt.add_argument("--publish-dir", default=None,
                     help="deploy: watch this directory for published "
                          "weight manifests and roll them out live, "
                          "canary first")
    flt.add_argument("--canary-steps", type=int, default=24,
                     help="deploy: fleet steps the canary serves new "
                          "weights off-ring before its gates decide "
                          "promote or rollback (default: 24)")
    rob = p.add_argument_group("robustness")
    rob.add_argument("--max-waiting", type=int, default=None,
                     help="bound on the waiting queue; overflow is SHED "
                          "deterministically (default: unbounded)")
    rob.add_argument("--deadline-ms", type=float, default=None,
                     help="TTL applied to every request")
    rob.add_argument("--request-retries", type=int,
                     default=DEFAULT_REQUEST_RETRIES,
                     help="per-request re-prefill budget (default: "
                          f"{DEFAULT_REQUEST_RETRIES})")
    rob.add_argument("--drain-timeout", type=float, default=30.0,
                     help="seconds in-flight work gets to finish after "
                          "SIGTERM before it is shed (graceful drain)")
    rob.add_argument("--step-timeout", type=float, default=0.0,
                     help="arm a StepWatchdog around every step's host "
                          "sync; a hung step dumps stacks + queue depths "
                          "and exits 87 (0 = off)")
    rob.add_argument("--progress-file", default=None,
                     help="append one line per decode step")
    p.add_argument("--json", dest="json_out",
                   help="write the report here instead of stdout")
    return p


def _demo_model(seed, device):
    from ..examples.lm.model import build_model

    return build_model(
        "transformer_lm", vocab_size=97, seed=seed, device=device,
        decoder_layers=2, decoder_embed_dim=64, decoder_ffn_embed_dim=128,
        decoder_attention_heads=4, max_seq_len=256,
    )


def _checkpoint_model(path, dict_path):
    """The checkpoint's model (CPU, fp32; the engine moves it to its
    device); a file serving cannot use exits with the reason."""
    from ..deploy import DeployError, load_serve_model

    try:
        return load_serve_model(path, dict_path)
    except (DeployError, NotImplementedError) as e:
        raise SystemExit(str(e)) from e


def _demo_requests(args, vocab, rng):
    lo, hi = (int(x) for x in args.prompt_len_range.split(","))
    reqs = []
    for i in range(args.num_requests):
        n = int(rng.integers(lo, hi))
        prompt = rng.integers(1, vocab, size=(n,)).tolist()
        reqs.append(Request(
            prompt=[int(t) for t in prompt],
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature, top_k=args.top_k,
            seed=args.seed + i, request_id=f"demo-{i}",
            deadline_ms=args.deadline_ms,
        ))
    return reqs


def _file_requests(args, path):
    reqs = []
    with open(path) as f:
        for i, line in enumerate(f):
            toks = [int(t) for t in line.split()]
            if not toks:
                continue
            reqs.append(Request(
                prompt=toks, max_new_tokens=args.max_new_tokens,
                temperature=args.temperature, top_k=args.top_k,
                seed=args.seed + i, request_id=f"req-{i}",
                deadline_ms=args.deadline_ms,
            ))
    return reqs


def _engine_kwargs(args):
    return dict(
        device=args.device, num_pages=args.num_pages,
        page_size=args.page_size, max_batch=args.max_batch,
        prefill_token_budget=args.prefill_token_budget,
        prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache == "on",
        max_waiting=args.max_waiting,
        request_retries=args.request_retries,
        drain_timeout=args.drain_timeout, step_timeout=args.step_timeout,
        progress_path=args.progress_file,
    )


def _result_record(r):
    return {
        "request_id": r.request_id,
        "prompt": r.prompt,
        "tokens": r.tokens,
        "finish_reason": r.finish_reason,
        "ttft_ms": None if r.ttft_ms is None else round(r.ttft_ms, 2),
        "evictions": r.evictions,
    }


def _rounded(stats):
    return {k: (round(v, 4) if isinstance(v, float) else v)
            for k, v in stats.items()}


def _write(args, report):
    text = json.dumps(report, indent=2)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(text + "\n")
        logger.info("wrote %s", args.json_out)
    else:
        print(text)


def _fleet_main(args, model, requests, shutdown):
    """``--fleet``: route the requests through a FleetRouter over
    ``--replicas`` in-process engines that share ``model``, drive the
    fleet to completion, then drain every replica: the report shows
    every pool idle and one drain record per replica."""
    from ..fleet.health import CircuitBreaker, ReplicaHealth
    from ..fleet.router import FleetRouter

    def make_engine(rid):
        del rid
        return ServeEngine(model, **_engine_kwargs(args))

    engines = {f"r{i}": make_engine(f"r{i}")
               for i in range(max(1, args.replicas))}
    router = FleetRouter(
        engines, shutdown=shutdown,
        # dead replicas are evicted and replaced through the circuit
        # breaker's canary probe; the same recipe builds the replacement
        factory=make_engine,
        max_failovers=args.max_failovers,
        health=ReplicaHealth(suspect_steps=args.suspect_steps,
                             dead_steps=args.progress_budget_steps),
        breaker=lambda rid: CircuitBreaker(
            cooldown_steps=args.breaker_cooldown,
            flap_limit=args.flap_limit),
    )
    if args.autoscale:
        from ..fleet.autoscaler import FleetAutoscaler

        # its describe() rides out through fleet_report()["autoscale"]
        router.attach_autoscaler(FleetAutoscaler(
            router, min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            cooldown_steps=args.scale_cooldown_steps))
    if args.publish_dir:
        from ..deploy import DeploySubscriber, RolloutController

        # the controller attaches itself to the router; its describe()
        # rides out through fleet_report()["deploy"]
        RolloutController(router, DeploySubscriber(args.publish_dir),
                          canary_steps=args.canary_steps)
    logger.info(
        "fleet: %d request(s) over %d session(s) into %d replica(s) on "
        "%s (pool %d pages x %d slots each, max batch %d)",
        len(requests), args.sessions, len(engines), args.device,
        args.num_pages, args.page_size, args.max_batch,
    )
    try:
        for i, req in enumerate(requests):
            router.submit(req,
                          session_key=f"s{i % max(1, args.sessions)}")
        router.run_until_complete()
        drains = router.drain()
        results = router.results()
    finally:
        router.close()
    # every pool the run still holds: the originals and the replicas the
    # autoscaler booted; a retired replica's pool was held idle when it
    # retired (its record in the fleet report) and is released
    audited = dict(engines)
    audited.update(router.engines)
    pool_clean = all(e.pool.is_idle() for e in audited.values())
    for eng in audited.values():
        eng.pool.check_invariants()
    _write(args, {
        "device": str(next(iter(audited.values())).device),
        "results": [_result_record(results[r.request_id])
                    for r in requests],
        "replicas": {
            rid: {
                "stats": _rounded(engines[rid].stats),
                # a replica evicted by failover has no drain record: the
                # fleet report's "lost" section carries its story
                "drain": drains.get(rid),
                "pool_clean": engines[rid].pool.is_idle(),
            }
            for rid in sorted(engines)
        },
        "fleet": router.fleet_report(),
        "sessions": {s: rids for s, rids in
                     sorted(router.session_replicas.items())},
        "pool_clean": pool_clean,
    })
    return 0


def main(argv=None):
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        level="INFO", stream=sys.stderr,
    )
    args = make_parser().parse_args(argv)
    if not args.demo and not args.checkpoint:
        raise SystemExit("need --checkpoint (with --dict) or --demo")
    # an impossible autoscale envelope fails at the parser, not mid-run
    if args.autoscale and not args.fleet:
        raise SystemExit("--autoscale needs --fleet (the scaling "
                         "policy steps with the fleet router)")
    if args.min_replicas > args.max_replicas:
        raise SystemExit(
            f"--min-replicas {args.min_replicas} > --max-replicas "
            f"{args.max_replicas}: the autoscale envelope is empty"
        )

    if args.demo:
        model = _demo_model(args.seed, args.device)
        rng = np.random.default_rng(args.seed)
        requests = (_file_requests(args, args.prompts) if args.prompts
                    else _demo_requests(args, model.vocab_size, rng))
    else:
        if not args.dict_path:
            raise SystemExit("--checkpoint needs --dict")
        if not args.prompts:
            raise SystemExit("--checkpoint needs --prompts")
        model = _checkpoint_model(args.checkpoint, args.dict_path)
        requests = _file_requests(args, args.prompts)
    for req in requests:
        bad = [t for t in req.prompt if not 0 <= t < model.vocab_size]
        if bad:
            raise SystemExit(
                f"{req.request_id}: prompt ids {bad[:5]} outside the "
                f"model's vocab [0, {model.vocab_size}) — wrong "
                "dictionary for this checkpoint?"
            )

    # SIGTERM/SIGINT -> graceful drain: admission closes at the next
    # step boundary, in-flight work gets --drain-timeout to finish or
    # is shed, and the process still writes its report and exits 0
    shutdown = GracefulShutdown().install()
    if args.fleet:
        try:
            return _fleet_main(args, model, requests, shutdown)
        finally:
            shutdown.uninstall()
    engine = ServeEngine(model, shutdown=shutdown, **_engine_kwargs(args))
    logger.info(
        "serving %d request(s) on %s: pool %d pages x %d slots, max "
        "batch %d", len(requests), engine.device, args.num_pages,
        args.page_size, args.max_batch,
    )
    try:
        results = engine.generate(requests)
    finally:
        shutdown.uninstall()
    pool_clean = engine.pool.is_idle()
    engine.pool.check_invariants()
    report = {
        "device": str(engine.device),
        "results": [_result_record(r) for r in results],
        "stats": _rounded(engine.stats),
        "drain": engine.drain_report,
        "pool_clean": pool_clean,
    }
    if shutdown.requested and engine.drain_report is None:
        # the signal landed after the last step boundary: nothing was
        # in flight, but the operator still gets a drain record with
        # the same shape (and signal) a mid-stream drain reports
        report["drain"] = {
            "requested": True,
            "signal": (None if shutdown.signum is None
                       else signal.Signals(shutdown.signum).name),
            "drain_ms": 0.0,
            "drain_timeout_s": args.drain_timeout,
            "shed": 0, "expired": 0,
            "deadline_exceeded": False,
            "pool_idle": pool_clean,
        }
    _write(args, report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
