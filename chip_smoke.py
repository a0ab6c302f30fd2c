#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``unicore_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failed phase raises, so the exit
code is non-zero:

1. build — compile every kernel of the serve path from
   ``unicore_tpu_torch/csrc/`` with ``nvcc`` for sm_90a (one process per
   source, started together).
2. kernel — the paged-attention kernel vs its plain PyTorch version at
   the serve path's shapes (B=16, H=12, D=64, page size 16, fp32): pure
   decode (T=1), full prefill chunks (T=32) and a mixed batch with -1
   tail positions and an inactive row, random page permutations.  Every
   output finite, max |kernel - plain| <= 1e-4 at every position.  Times
   the kernel, the plain version and ``F.scaled_dot_product_attention``
   over the gathered K/V (a yardstick the port never calls) beside the
   least time the card could take.
3. serve — a seeded random ``transformer_lm_base`` (12 layers, width 768,
   FFN 3072, 12 heads, vocab 30522, rotary, context 512) behind
   ``ServeEngine(num_pages=512, page_size=16, max_batch=16)``: 16 greedy
   requests with 16-448-token prompts, then 4 whose prompts open with 128
   tokens of an earlier one.  Checks finish reasons, an idle pool, a
   prefix hit, and that the kernel launched once per layer per ragged
   dispatch.
4. solo — for 3 requests, one of them a prefix-cache hit, the
   full-forward greedy decode equals the engine's tokens.
5. profile — device busy and idle time of a decode-heavy window, and
   the kernels that take the most time (``torch.profiler``).
6. the ``kernels`` line, the card's name and power limit, and the
   closing ``{"ok": true, ...}`` line.

Exits non-zero without a card, and without the repository around it.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

PAGE_SIZE, HEADS, HEAD_DIM, BATCH, CHUNK = 16, 12, 64, 16, 32
NUM_PAGES, CONTEXT = 512, 512
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
TOL = 1e-4                  # fp32, summation order differs


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, flush, iters=30):
    """Median device time of one call, by CUDA events around each call,
    with L2 flushed before it (the serve step finds the pools cold:
    twelve layers' pools are ~600 MB)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def make_case(rng, kind):
    """Operands of one ragged step at the serve path's shapes.  Rows get
    disjoint pages from a random permutation of the pool (page 0, the
    trash page, is never handed out); table rows pad with page 0."""
    T = 1 if kind == "decode" else CHUNK
    width = CONTEXT // PAGE_SIZE
    lengths = rng.integers(T + 16, CONTEXT - 32, size=BATCH).astype(np.int32)
    positions = np.full((BATCH, T), -1, np.int32)
    for b in range(BATCH):
        positions[b] = np.arange(lengths[b] - T, lengths[b])
    if kind == "mixed":
        for b in range(4, 10):   # decode rows
            positions[b, 1:] = -1
            positions[b, 0] = lengths[b] - 1
        positions[10, 20:] = -1  # a short tail chunk
        lengths[10] = positions[10, 19] + 1
        lengths[11] = 0          # an inactive row
        positions[11] = -1
    perm = rng.permutation(NUM_PAGES - 1) + 1
    table = np.zeros((BATCH, width), np.int32)
    used = 0
    for b in range(BATCH):
        n = -(-int(lengths[b]) // PAGE_SIZE)
        table[b, :n] = perm[used:used + n]
        used += n
    slots = NUM_PAGES * PAGE_SIZE
    k = rng.standard_normal((slots, HEADS, HEAD_DIM), dtype=np.float32)
    v = rng.standard_normal((slots, HEADS, HEAD_DIM), dtype=np.float32)
    q = rng.standard_normal((BATCH, T, HEADS, HEAD_DIM), dtype=np.float32)
    return q, k, v, table, positions, lengths


def bound(case):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    over HBM bandwidth and its fp32 operations over the fp32 rate.  The
    bytes: each row's K and V columns that some query admits — the first
    ``min(len_b, max_t positions[b, t] + 1)`` of the row — once, the table
    entries of their pages, q, positions and lengths read and out written.
    The operations: per admitted (query, column) pair and head, a dot
    product of D for the score and D multiply-adds for the output."""
    q, _, _, _, positions, lengths = case
    cols = np.minimum(lengths.astype(np.int64),
                      positions.max(axis=1).astype(np.int64) + 1).clip(min=0)
    pages = -(-cols // PAGE_SIZE)
    nbytes = (int(cols.sum()) * HEADS * HEAD_DIM * 4 * 2
              + 2 * q.nbytes + 4 * int(pages.sum()) + positions.nbytes
              + lengths.nbytes)
    admitted = np.minimum(positions + 1, lengths[:, None]).clip(min=0)
    flops = int(admitted.sum()) * HEADS * HEAD_DIM * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(pa, flush):
    import torch.nn.functional as F

    rng = np.random.default_rng(20261016)
    scale = HEAD_DIM ** -0.5
    cases = {}
    for kind in ("decode", "prefill", "mixed"):
        case = make_case(rng, kind)
        q, k, v, table, positions, lengths = (
            torch.from_numpy(x).cuda() for x in case)

        def kernel():
            return pa.ragged_paged_attention(
                q, k, v, table, positions, lengths, page_size=PAGE_SIZE,
                scale=scale)

        def plain():
            return pa.paged_attention_plain(
                q, k, v, table, positions, lengths, PAGE_SIZE, scale)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            raise AssertionError(f"{kind}: non-finite attention output")
        err = float((got - want).abs().max())
        if err > TOL:
            raise AssertionError(f"{kind}: max |kernel - plain| {err} > {TOL}")
        # the library yardstick: SDPA over the gathered K/V, position mask
        kg = pa.gather_slots(k, table, PAGE_SIZE).transpose(1, 2).contiguous()
        vg = pa.gather_slots(v, table, PAGE_SIZE).transpose(1, 2).contiguous()
        qh = q.transpose(1, 2).contiguous()
        cols = torch.arange(kg.shape[2], device="cuda")
        mask = ((cols[None, None, :] <= positions[:, :, None])
                & (cols[None, None, :] < lengths[:, None, None]))[:, None]

        def library():
            return F.scaled_dot_product_attention(qh, kg, vg, attn_mask=mask,
                                                  scale=scale)

        bound_ms, bound_by = bound(case)
        cases[kind] = {
            "T": int(q.shape[1]), "max_abs_err": err,
            "ms": time_ms(kernel, flush), "plain_ms": time_ms(plain, flush),
            "library_ms": time_ms(library, flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tokens": int(lengths.sum()),
        }
        emit("kernel", case=kind, **cases[kind])
    return cases


def serve_phase(pa):
    from unicore_tpu_torch.examples.lm.model import build_model
    from unicore_tpu_torch.serve.engine import ServeEngine
    from unicore_tpu_torch.serve.scheduler import Request

    t0 = time.perf_counter()
    model = build_model("transformer_lm_base", vocab_size=30522, seed=0,
                        device="cuda")
    engine = ServeEngine(model, device="cuda", num_pages=NUM_PAGES,
                         page_size=PAGE_SIZE, max_batch=BATCH)
    build_s = time.perf_counter() - t0
    vocab, layers = model.vocab_size, model.decoder_layers
    rng = np.random.default_rng(1106)
    # warm-up (cuBLAS handles, the kernel library's first load), outside
    # the counted run
    engine.generate([Request(prompt=[5] * 20, max_new_tokens=2)])
    first = [Request(prompt=rng.integers(1, vocab, size=int(n)).tolist(),
                     max_new_tokens=32, eos_id=2, request_id=f"a{i}")
             for i, n in enumerate(rng.integers(16, 449, size=16))]
    donor = max(first, key=lambda r: len(r.prompt)).prompt[:128]
    second = [Request(prompt=donor + rng.integers(
                          1, vocab, size=int(n)).tolist(),
                      max_new_tokens=32, eos_id=2, request_id=f"b{i}")
              for i, n in enumerate(rng.integers(16, 64, size=4))]
    before, decode_steps0 = dict(engine.stats), len(engine.decode_ms)
    pa.ragged_paged_attention.launches = 0
    t0 = time.perf_counter()
    results = engine.generate(first) + engine.generate(second)
    wall_s = time.perf_counter() - t0
    launches = pa.ragged_paged_attention.launches
    stats = {k: engine.stats[k] - before.get(k, 0)
             for k in ("ragged_dispatches", "decode_tokens",
                       "decode_time_s", "prefix_hits",
                       "prefix_tokens_saved")}
    dispatches = stats["ragged_dispatches"]
    reasons = sorted({r.finish_reason for r in results})
    if not set(reasons) <= {"eos", "length", "capacity"}:
        raise AssertionError(f"unexpected finish reasons {reasons}")
    if not engine.pool.is_idle():
        raise AssertionError("pool not idle after the run")
    engine.pool.check_invariants()
    if stats["prefix_hits"] < 1:
        raise AssertionError("no prefix hit in the second generate()")
    if launches != layers * dispatches or dispatches == 0:
        raise AssertionError(f"{launches} kernel launches for {dispatches} "
                             f"ragged dispatches of {layers} layers")
    ttft = np.array([r.ttft_ms for r in results])
    emit("serve", model="transformer_lm_base", setup_s=build_s,
         requests=len(results), finish_reasons=reasons,
         generated_tokens=sum(len(r.tokens) for r in results),
         wall_s=wall_s, ragged_dispatches=dispatches, launches=launches,
         evictions=engine.stats["evictions"],
         prefix_hits=stats["prefix_hits"],
         prefix_tokens_saved=stats["prefix_tokens_saved"],
         decode_tokens_per_s=stats["decode_tokens"] / stats["decode_time_s"],
         ttft_p50_ms=float(np.percentile(ttft, 50)),
         ttft_p99_ms=float(np.percentile(ttft, 99)),
         decode_step_median_ms=float(np.median(
             list(engine.decode_ms)[decode_steps0:])))
    return model, first, second, results, launches


def solo_phase(model, first, second, results):
    """The port's full-forward greedy decode equals the engine's tokens,
    for the shortest and the longest prompt of the first call and the
    longest of the second — a prefix-cache hit, whose prefill starts past
    the shared pages and whose attention reads pages another sequence
    wrote.  A divergence passes only at a step whose top-2 logit gap is
    below 1e-4 — a tie under fp32 summation order — and is reported."""
    from unicore_tpu_torch.examples.lm.model import solo_greedy

    by_id = {r.request_id: r for r in results}
    picks = [min(first, key=lambda r: len(r.prompt)),
             max(first, key=lambda r: len(r.prompt)),
             max(second, key=lambda r: len(r.prompt))]
    report = []
    for req in picks:
        solo, margins = solo_greedy(model, req.prompt, req.max_new_tokens,
                                    eos_id=req.eos_id)
        got = by_id[req.request_id].tokens
        diverge = next((i for i, (a, b) in enumerate(zip(solo, got))
                        if a != b), None)
        if diverge is None and len(solo) != len(got):
            raise AssertionError(f"{req.request_id}: lengths differ")
        if diverge is not None and margins[diverge] >= 1e-4:
            raise AssertionError(
                f"{req.request_id}: engine and solo decode diverge at step "
                f"{diverge} (margin {margins[diverge]})")
        report.append({"request": req.request_id,
                       "prompt_len": len(req.prompt),
                       "tokens": len(got), "equal": diverge is None,
                       "tie_at": diverge,
                       "min_margin": float(min(margins))})
    emit("solo", checks=report)


def profile_phase(model):
    """Where a decode-heavy window's time goes: ``torch.profiler`` over 8
    requests (64-token prompts, 16 new tokens each) — device busy time
    (the sum of kernel times; one stream, so no overlap) against wall
    time, and the kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unicore_tpu_torch.serve.engine import ServeEngine
    from unicore_tpu_torch.serve.scheduler import Request

    engine = ServeEngine(model, device="cuda", num_pages=NUM_PAGES,
                         page_size=PAGE_SIZE, max_batch=BATCH)
    rng = np.random.default_rng(7)
    reqs = [Request(prompt=rng.integers(1, model.vocab_size, 64).tolist(),
                    max_new_tokens=16, request_id=f"p{i}") for i in range(8)]
    engine.generate([Request(prompt=[5] * 20, max_new_tokens=2)])
    dispatches0 = engine.stats["ragged_dispatches"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.generate(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    emit("profile", window="8 requests x 16 new tokens, 64-token prompts",
         ragged_dispatches=engine.stats["ragged_dispatches"] - dispatches0,
         wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
         kernel_launches=sum(e.count for e in kernels),
         top_kernels=[{"name": e.key[:80], "count": e.count,
                       "ms": e.self_device_time_total / 1e3} for e in top])


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from unicore_tpu_torch.ops import build
    from unicore_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = build.build(["paged_attention"])
    emit("build", kernels={
        name: {"seconds": r["seconds"],
               "ptxas": [ln.strip() for ln in r["log"].splitlines()
                         if "registers" in ln or "smem" in ln]}
        for name, r in report.items()})
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    cases = kernel_phase(pa, flush)
    del flush
    model, first, second, results, launches = serve_phase(pa)
    solo_phase(model, first, second, results)
    profile_phase(model)
    decode = cases["decode"]
    print(json.dumps({"kernels": [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "unicore_tpu_torch/csrc/paged_attention.cu",
        "replaces": "unicore_tpu/ops/pallas/paged_attention.py:65",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
        "ms": decode["ms"], "plain_ms": decode["plain_ms"],
        "bound_ms": decode["bound_ms"], "bound_by": decode["bound_by"],
        "library_ms": decode["library_ms"],
        "cases": cases,
    }]}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
