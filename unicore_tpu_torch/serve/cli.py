"""``python -m unicore_tpu_torch.serve``: offline batch generation through
the port's continuous-batching engine (counterpart of the solo path of
``unicore_tpu/serve/cli.py``).

``--demo`` serves a tiny model with seeded random weights on random
prompts of mixed lengths — the zero-setup smoke path.  ``--checkpoint``
and ``--fleet`` are not ported yet and exit saying so.  ``--device``
picks the device (default ``cuda``; without a card the run fails rather
than falling back to the CPU).

Output: one JSON object (``--json FILE`` or stdout) with per-request
generated ids, finish reasons, TTFT, and the engine's aggregate stats.
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

NOT_PORTED = "is not ported to unicore_tpu_torch yet"


def make_parser():
    p = argparse.ArgumentParser(
        "unicore_tpu_torch.serve",
        description="offline batch generation via the paged-KV "
                    "continuous-batching engine (PyTorch/CUDA port)",
    )
    src = p.add_argument_group("model source")
    src.add_argument("--checkpoint", help=f"framework checkpoint ({NOT_PORTED})")
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
                     help=f"> 0 {NOT_PORTED}: greedy only")
    req.add_argument("--top-k", type=int, default=0)
    req.add_argument("--seed", type=int, default=1)
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
    eng.add_argument("--fleet", action="store_true",
                     help=f"route through a fleet router ({NOT_PORTED})")
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
                     help=f"step watchdog ({NOT_PORTED}; 0 = off)")
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


def main(argv=None):
    logging.basicConfig(
        format="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        level="INFO", stream=sys.stderr,
    )
    args = make_parser().parse_args(argv)
    for flag, used in (("--checkpoint", args.checkpoint),
                       ("--fleet", args.fleet),
                       ("--step-timeout", args.step_timeout > 0),
                       ("--temperature", args.temperature > 0)):
        if used:
            raise SystemExit(f"{flag} {NOT_PORTED}")
    if not args.demo:
        raise SystemExit("need --demo (--checkpoint " + NOT_PORTED + ")")

    model = _demo_model(args.seed, args.device)
    rng = np.random.default_rng(args.seed)
    requests = (_file_requests(args, args.prompts) if args.prompts
                else _demo_requests(args, model.vocab_size, rng))
    for req in requests:
        bad = [t for t in req.prompt if not 0 <= t < model.vocab_size]
        if bad:
            raise SystemExit(
                f"{req.request_id}: prompt ids {bad[:5]} outside the "
                f"model's vocab [0, {model.vocab_size})"
            )

    # SIGTERM/SIGINT -> graceful drain: admission closes at the next
    # step boundary, in-flight work gets --drain-timeout to finish or
    # is shed, and the process still writes its report and exits 0
    shutdown = GracefulShutdown().install()
    engine = ServeEngine(
        model, device=args.device, num_pages=args.num_pages,
        page_size=args.page_size, max_batch=args.max_batch,
        prefill_token_budget=args.prefill_token_budget,
        prefill_chunk=args.prefill_chunk,
        prefix_cache=args.prefix_cache == "on",
        max_waiting=args.max_waiting,
        request_retries=args.request_retries,
        drain_timeout=args.drain_timeout, shutdown=shutdown,
    )
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
        "results": [
            {
                "request_id": r.request_id,
                "prompt": r.prompt,
                "tokens": r.tokens,
                "finish_reason": r.finish_reason,
                "ttft_ms": (None if r.ttft_ms is None
                            else round(r.ttft_ms, 2)),
                "evictions": r.evictions,
            }
            for r in results
        ],
        "stats": {k: (round(v, 4) if isinstance(v, float) else v)
                  for k, v in engine.stats.items()},
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
    text = json.dumps(report, indent=2)
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(text + "\n")
        logger.info("wrote %s", args.json_out)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
