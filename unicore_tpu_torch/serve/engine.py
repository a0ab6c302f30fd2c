"""ServeEngine: continuous-batching generation over the paged KV pool
(counterpart of ``unicore_tpu/serve/engine.py``).

Every step is ONE ragged dispatch: each batch row carries per-sequence
``(start, len, decode?)`` metadata — a decode row holds a single token, a
prefill row a CHUNK of its prompt — and both run in the same model call.
A step has one of two widths: 1 when every row is a single token, the
prefill chunk otherwise.  The pool's k/v buffers are allocated once and
updated in place by every step (where the JAX engine donated them through
its jitted step); only the [B] picked token ids and finite-row flags
cross back to the host.

The pool is multi-tenant: ``kv_pool.py`` dedups shared prefixes by chain
hash, so a repeat of a warm prompt prefix becomes a page-table lookup
instead of a prefill (``prefix_cache=True``).

Robustness, as in the JAX engine: a row whose logits are not finite is
QUARANTINED (it finishes ``"failed"``, the rest of the batch continues); a
host-side fault fails only the in-flight sequences; a drain (a wired
:class:`~unicore_tpu_torch.resilience.preemption.GracefulShutdown` or
:meth:`request_drain`) closes admission, sheds what waits and gives the
running requests ``drain_timeout`` seconds; a request that can never fit
the pool finishes ``"capacity"``.  A kernel that fails to build or launch
(:class:`~unicore_tpu_torch.ops.build.KernelError`) or a CUDA error is
not a per-request fault and propagates.

Sampling, as in the JAX engine: each step picks ``"greedy"``,
``"temp"`` or ``"topk"`` from its live rows (:meth:`_sampling_mode`); a
sampled row draws with ``fold_in(PRNGKey(req.seed), len(generated))``,
derived on the device from the rows' seeds and steps, so a preempted and
re-prefilled request resumes at the same fold index and its tokens are
the JAX engine's for the same seed.

Watchdog: ``step_timeout > 0`` arms a :class:`~unicore_tpu_torch.
resilience.watchdog.StepWatchdog` around each step's one host sync (the
``.cpu()`` of the picked tokens; kernel launches, and a kernel's build
at its first launch, stay outside the window), with a context line
naming the queue depths before the process exits 87.

Fleet-facing API, as in the JAX engine: :meth:`submit` enqueues,
:meth:`serve_step` advances one scheduler iteration,
:meth:`collect_finished` drains results, :meth:`load_snapshot` is the
typed load and health snapshot a router polls, :meth:`adopt` takes a
request salvaged from a dead replica with its generated tokens, and
:meth:`reclaim_waiting` / :meth:`reopen` are the rolling-restart hooks.
One injectable ``clock`` stamps enqueues, TTFT, deadlines and the drain
timer.

Live weight swaps (:meth:`swap_weights`) take the flax-layout host tree
that ``deploy/loader.py`` loads, and :attr:`params` gives the tree the
engine serves.  Replicas of an in-process fleet share one boot module,
so an engine's first swap gives it its own parameter storage (the
staged tensors become its module's parameters; nothing a sibling or the
caller holds is written), and later swaps copy in place, so parameter
addresses stay fixed.

Not ported yet: the autotuner's prefill-chunk lookup (ROADMAP.md A14)
and the static and determinism audit surfaces (``trace_step_fns``,
``width_fn``, ``_input_capture``; A15).
"""

import contextlib
import copy
import dataclasses
import logging
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.build import KernelError
from ..resilience.watchdog import StepWatchdog
from .attention import PagedMeta
from .kv_pool import PagedKVPool, PoolExhausted
from .sampling import finite_rows, greedy_tokens, sample_tokens, step_keys
from .scheduler import DEFAULT_REQUEST_RETRIES, Scheduler

logger = logging.getLogger(__name__)

DEFAULT_PREFILL_CHUNK = 32

# faults of the device path itself, never of one request: a kernel that
# does not build or launch, and a CUDA error (sticky — the context is
# unusable after it, as the JAX engine's consumed donated buffers were)
DEVICE_FAULTS = (KernelError, getattr(torch, "AcceleratorError", KernelError))


@dataclasses.dataclass
class ServeResult:
    request_id: Optional[str]
    prompt: List[int]
    tokens: List[int]          # generated tokens (eos included if hit)
    # "eos" | "length" | "capacity" | "expired" | "shed" | "failed" —
    # plus "replica_lost", synthesized by the fleet router (never by an
    # engine) when a request outlives max_failovers replica deaths
    finish_reason: str
    ttft_ms: Optional[float]   # None when no token was ever emitted
    evictions: int


class WeightSwapError(RuntimeError):
    """Typed hot-swap precondition failure: the incoming param tree does
    not match the serving tree (structure, leaf shape or dtype).  It is
    raised before anything is written; the deploy rollout treats it like
    any other bad-manifest fault: quarantine and roll back."""


class ServeEngine:
    """Continuous-batching generation engine over a paged KV pool.

    ``model`` is a decoder LM following the port's ``examples/lm``
    contract: ``features(tokens, positions=..., paged=...)`` -> [B, T, D]
    and ``head(x)`` -> logits, plus ``max_seq_len``/``padding_idx``/
    ``decoder_layers``/``decoder_attention_heads``/``decoder_embed_dim``
    attributes.  It is moved to ``device`` (default the card; raises
    without one)."""

    def __init__(self, model, *, device="cuda", num_pages=64, page_size=16,
                 max_batch=8, prefill_token_budget=512, max_context=None,
                 prefill_chunk=0, prefix_cache=True, unified=True,
                 chaos_rate=0.0, chaos_rng=None, max_waiting=None,
                 request_retries=DEFAULT_REQUEST_RETRIES,
                 drain_timeout=30.0, shutdown=None, step_timeout=0.0,
                 clock=None, poison_requests=None, progress_path=None):
        self.device = resolve_device(device)
        # the serve path is fp32 end to end: full fp32 matmuls, no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = model.to(self.device).eval()
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_batch = int(max_batch)
        self.prefill_token_budget = int(prefill_token_budget)
        cap = (self.num_pages - 1) * self.page_size
        self.max_context = min(
            int(max_context or model.max_seq_len), model.max_seq_len, cap
        )
        self.num_slots = self.num_pages * self.page_size
        self.pool = PagedKVPool(self.num_pages, self.page_size,
                                prefix_cache=prefix_cache)
        self.table_width = self.pool.pages_for(self.max_context)
        # unified=False is the A/B baseline: prefill rows and decode rows
        # dispatch as two separate steps instead of one mixed dispatch
        self.unified = bool(unified)
        self.scheduler = Scheduler(
            self.pool, self.max_batch,
            prefill_token_budget=self.prefill_token_budget,
            chaos_rate=chaos_rate, chaos_rng=chaos_rng,
            max_waiting=max_waiting, request_retries=request_retries,
        )
        self.pages = self._init_pages()
        # prefill-chunk width: a prompt is admitted in <= this many
        # tokens per ragged step (bounded-TTFT slices); 0 = the default
        chunk = int(prefill_chunk) or DEFAULT_PREFILL_CHUNK
        self.prefill_chunk = max(1, min(chunk, self.max_context))
        # one host clock for enqueue stamps, TTFT, deadlines and the
        # drain timer — injectable so deadline and drain tests are exact
        self._clock = clock or time.perf_counter
        self.drain_timeout = float(drain_timeout)
        self.shutdown = shutdown
        self.drain_report = None
        self._drain_flag = False
        self._drain_started = None
        self._draining = False
        self._drain_shed0 = 0
        self._drain_expired0 = 0
        self._stalled = 0
        self.progress_path = progress_path
        # seeded poisoned-request injection (the quarantine test hook):
        # listed request ids get their sampled-from logits row NaN'd
        # inside the step
        self._poison_ids = frozenset(poison_requests or ())
        self.watchdog = None
        if step_timeout and float(step_timeout) > 0:
            self.watchdog = StepWatchdog(float(step_timeout),
                                         context=self._watchdog_context)
        # recent per-decode-step wall latencies
        self.decode_ms = deque(maxlen=4096)
        self.stats = {
            "prefills": 0, "decode_steps": 0, "decode_tokens": 0,
            "generated_tokens": 0, "ragged_dispatches": 0,
            "peak_pool_occupancy": 0.0,
            "decode_time_s": 0.0, "wall_time_s": 0.0,
            "pool_exhausted_recoveries": 0,
            "shed": 0, "expired": 0, "quarantined": 0, "host_faults": 0,
            "capacity_failfast": 0, "peak_waiting": 0,
            "prefix_hits": 0, "prefix_tokens_saved": 0,
        }
        # live weight swaps installed by swap_weights; _owns_params flips
        # on the first swap: the boot module may be SHARED (the other
        # replicas of an in-process fleet, the caller), so only storage
        # the engine placed itself is written in place
        self.weight_swaps = 0
        self._owns_params = False

    # -- pool buffers --------------------------------------------------

    def _init_pages(self):
        """One ``(k_pages, v_pages)`` pair of ``[num_slots, H, Dh]``
        buffers per decoder layer, in the params' dtype, allocated once."""
        m = self.model
        heads = m.decoder_attention_heads
        shape = (self.num_slots, heads, m.decoder_embed_dim // heads)
        dtype = next(m.parameters()).dtype
        return [
            (torch.zeros(shape, dtype=dtype, device=self.device),
             torch.zeros(shape, dtype=dtype, device=self.device))
            for _ in range(m.decoder_layers)
        ]

    # -- the one ragged step -------------------------------------------

    @staticmethod
    def _pick_tokens(logits, seeds, steps, temperature, top_k, sampling):
        """``sampling`` is the step's mode: ``"greedy"`` skips the whole
        sampling composition, ``"temp"`` skips the full-vocab top-k sort,
        ``"topk"`` runs everything (a row samples identically under any
        mode that covers it)."""
        if sampling == "greedy":
            return greedy_tokens(logits)
        return sample_tokens(logits, step_keys(seeds, steps), temperature,
                             top_k, use_top_k=sampling == "topk")

    @staticmethod
    def _sampling_mode(seqs):
        if any(s.req.top_k > 0 and s.req.temperature > 0 for s in seqs):
            return "topk"
        if any(s.req.temperature > 0 for s in seqs):
            return "temp"
        return "greedy"

    @torch.no_grad()
    def _step(self, tokens, positions, tables, slot_mapping, lengths,
              last_col, poison, sampling="greedy", seeds=None, steps=None,
              temperature=None, top_k=None):
        """Run the model over one ragged batch (numpy host arrays) and
        pick each row's next token from its LAST real column's logits,
        by :meth:`_pick_tokens` (the per-row ``seeds``, ``steps``,
        ``temperature`` and ``top_k`` go to the device only when
        ``sampling`` is not greedy).  Returns host arrays
        ``(tokens [B], finite [B])``."""
        dev = self.device

        def h2d(a):
            return torch.from_numpy(a).to(dev)

        # a copy from pageable host memory synchronizes the stream, so
        # every one comes before the first launch: after it, the step's
        # only sync is the copy of the picked tokens back
        meta = PagedMeta(
            page_table=h2d(tables), slot_mapping=h2d(slot_mapping),
            lengths=h2d(lengths), page_size=self.page_size,
            kv_pages=self.pages,
        )
        tokens_d, positions_d, last_col_d = (
            h2d(a) for a in (tokens, positions, last_col))
        poison_d = None if poison is None else h2d(poison)
        if sampling != "greedy":
            seeds, steps, temperature, top_k = (
                h2d(a) for a in (seeds, steps, temperature, top_k))
        x = self.model.features(tokens_d, positions=positions_d, paged=meta)
        rows = x[torch.arange(x.shape[0], device=dev), last_col_d]
        logits = self.model.head(rows)
        if poison_d is not None:  # chaos injection
            logits = torch.where(poison_d[:, None],
                                 torch.full_like(logits, float("nan")),
                                 logits)
        picked = self._pick_tokens(logits, seeds, steps, temperature,
                                   top_k, sampling)
        out = torch.stack([picked.long(), finite_rows(logits).long()])
        # the step's one host sync, and the only armed window: a hung
        # kernel surfaces here, every launch (and build) came before it
        with self._armed(f"serve/ragged-w{tokens.shape[1]}"):
            out = out.cpu().numpy()
        return out[0], out[1].astype(bool)

    def _width_for(self, chunk):
        """Step width for a step whose widest row carries ``chunk``
        tokens: 1 when every row is a single token, the prefill chunk
        otherwise."""
        return 1 if chunk <= 1 else self.prefill_chunk

    # -- host-side step assembly ---------------------------------------

    def _armed(self, phase):
        """Watchdog guard for the step's blocking sync (a no-op when no
        ``step_timeout`` was configured)."""
        if self.watchdog is None:
            return contextlib.nullcontext()
        return self.watchdog.armed(phase)

    def close(self):
        """Stop the step watchdog's thread.  The engine keeps working
        unarmed; the router calls this for a replica it evicts or
        replaces, and the CLI for every replica when it is done."""
        if self.watchdog is not None:
            self.watchdog.close()

    def _watchdog_context(self):
        """Queue-depth snapshot for the watchdog's timeout dump: a hung
        serve step dies naming what was in flight."""
        sched = self.scheduler
        return (
            f"waiting={len(sched.waiting)} running={len(sched.running)} "
            f"prefills={self.stats['prefills']} "
            f"decode_steps={self.stats['decode_steps']} "
            f"pool_free_pages={self.pool.num_free_pages}"
        )

    def _quarantine(self, seq, phase):
        """Retire one poisoned-row sequence: reason ``"failed"``, pages
        freed (shared prefix pages drop one reference — survivors
        sharing the prefix keep theirs), batch untouched."""
        logger.warning(
            "quarantined request %r after a nonfinite logits row in %s "
            "(%d tokens emitted so far); the rest of the batch continues",
            seq.req.request_id, phase, len(seq.generated),
        )
        self.scheduler.finish(seq, "failed")
        self.stats["quarantined"] += 1

    @staticmethod
    def _is_decode_ready(seq):
        """A sequence whose only missing KV is its newest generated
        token (steady-state decode) vs one still advancing prefill."""
        return (bool(seq.generated)
                and seq.prefilled == len(seq.prefix()) - 1)

    def _plan_rows(self, seqs):
        """Assign this step's batch rows: ``[(seq, start, m, emit,
        is_decode), ...]``, at most ``max_batch`` of them.

        Decode-ready sequences take their single-token rows first (a
        running decode is never delayed by admission), then LEFTOVER
        row capacity soaks prompt chunks — one span per prefilling
        sequence in admission order, then EXTRA spans of the same
        prompts.  Several consecutive chunks of ONE prompt in one
        dispatch are sound because every layer's KV scatter lands
        before its attention reads: chunk k's queries see chunk j<k's
        keys written in the same step."""
        rows = []
        prefilling = []
        for seq in seqs:
            if self._is_decode_ready(seq):
                rows.append((seq, seq.prefilled, 1, True, True))
            else:
                prefilling.append([seq, seq.prefilled])
        while prefilling and len(rows) < self.max_batch:
            for entry in list(prefilling):
                if len(rows) >= self.max_batch:
                    break
                seq, start = entry
                total = len(seq.prefix())
                m = min(self.prefill_chunk, total - start)
                rows.append((seq, start, m, start + m == total, False))
                entry[1] = start + m
                if entry[1] >= total:
                    prefilling.remove(entry)
        return rows

    def _dispatch(self, rows):
        """ONE ragged step over planned ``rows``: build the per-row
        metadata, run the model, advance each sequence's prefill
        watermark, emit or quarantine.  Row assembly faults fail only
        that row's sequence."""
        B = self.max_batch
        w = self._width_for(max(m for _, _, m, _, _ in rows))
        tokens = np.zeros((B, w), np.int64)
        positions = np.full((B, w), -1, np.int32)
        tables = np.zeros((B, self.table_width), np.int32)
        slot_mapping = np.zeros((B * w,), np.int64)  # 0 = trash slot
        lengths = np.zeros((B,), np.int32)
        last_col = np.zeros((B,), np.int64)
        temperature = np.zeros((B,), np.float32)
        top_k = np.zeros((B,), np.int64)
        seeds = np.zeros((B,), np.int64)
        steps = np.zeros((B,), np.int64)
        packed = []
        for seq, start, m, emit, dec in rows:
            if seq.done:
                continue  # failed through an earlier row this step
            b = len(packed)
            try:
                prefix = seq.prefix()
                ptable = np.asarray(self.pool.page_table(seq.sid),
                                    np.int32)
                pos = np.arange(start, start + m)
                page_idx = pos // self.page_size
                if page_idx[-1] >= len(ptable):
                    raise IndexError(
                        f"position {start + m - 1} beyond the "
                        f"{len(ptable)} page(s) of sequence {seq.sid!r}"
                    )
                tokens[b, :m] = prefix[start:start + m]
                positions[b, :m] = pos
                tables[b, :len(ptable)] = ptable
                slot_mapping[b * w:b * w + m] = (
                    ptable[page_idx] * self.page_size
                    + pos % self.page_size
                )
                lengths[b] = start + m
                last_col[b] = m - 1
                temperature[b] = seq.req.temperature
                top_k[b] = seq.req.top_k
                seeds[b] = seq.req.seed
                steps[b] = len(seq.generated)
            except Exception as exc:  # noqa: BLE001 - per-row isolation
                # scrub the half-written row back to trash-slot defaults
                tokens[b] = 0
                positions[b] = -1
                tables[b] = 0
                slot_mapping[b * w:(b + 1) * w] = 0
                lengths[b] = 0
                self._host_fault([seq], "row-assembly", exc)
                continue
            packed.append((seq, start, m, emit, dec))
        rows = packed
        if not rows:
            return
        poison = None
        if self._poison_ids:
            poison = np.zeros((B,), bool)
            for b, (seq, *_rest) in enumerate(rows):
                poison[b] = seq.req.request_id in self._poison_ids
        any_decode = any(r[4] for r in rows)
        sampling = self._sampling_mode([r[0] for r in rows])
        t0 = time.perf_counter()
        toks, ok = self._step(tokens, positions, tables, slot_mapping,
                              lengths, last_col, poison, sampling, seeds,
                              steps, temperature, top_k)
        dt = time.perf_counter() - t0
        self.stats["ragged_dispatches"] += 1
        self.stats["prefills"] += sum(1 for r in rows if not r[4])
        if any_decode:
            self.stats["decode_time_s"] += dt
            self.decode_ms.append(dt * 1e3)
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += sum(1 for r in rows if r[4])
            if self.progress_path:
                with open(self.progress_path, "a") as fh:
                    fh.write(f"{self.stats['decode_steps']}\n")
        for b, (seq, start, m, emit, _) in enumerate(rows):
            if seq.done:
                continue  # quarantined through an earlier row this step
            if not bool(ok[b]):
                self._quarantine(seq, f"ragged-w{w}")
                continue
            seq.prefilled = start + m  # rows per seq are ascending
            if (not seq.prefix_registered
                    and seq.prefilled >= len(seq.req.prompt)):
                # the prompt's KV is fully written: index its full
                # pages so later shared-prefix requests dedup
                self.pool.register_prefix(seq.sid, seq.req.prompt)
                seq.prefix_registered = True
            if emit:
                self._emit(seq, int(toks[b]))

    def _emit(self, seq, token):
        """Append one picked token and settle termination."""
        seq.generated.append(token)
        self.stats["generated_tokens"] += 1
        if seq.first_token_at is None:
            seq.first_token_at = self._clock()  # enqueued_at's clock
        req = seq.req
        if req.eos_id is not None and token == req.eos_id:
            self.scheduler.finish(seq, "eos")
        elif len(seq.generated) >= req.max_new_tokens:
            self.scheduler.finish(seq, "length")
        elif len(seq.prefix()) > self.max_context:
            # the NEXT decode would need a KV slot at position
            # max_context — beyond the table width; truncate here
            self.scheduler.finish(seq, "capacity")

    # -- public API ----------------------------------------------------

    def submit(self, requests):
        """Validate and enqueue a batch of :class:`Request`s WITHOUT
        driving them; returns the scheduler's Sequence handles (the
        fleet router's admission path: pair with :meth:`serve_step` and
        :meth:`collect_finished`).  A bounded queue may shed some of
        them immediately; the shed sequences come back terminal."""
        self._validate_requests(requests)
        seqs = [self._enqueue(req) for req in requests]
        if self.scheduler.num_shed:
            self._sync_lifecycle_stats()
        return seqs

    def _enqueue(self, req, generated=None):
        """One validated request into the scheduler (may shed at once)
        with its enqueue stamp on the engine clock."""
        seq = self.scheduler.add(req, generated=generated)
        seq.enqueued_at = self._clock()
        self.stats["peak_waiting"] = max(
            self.stats["peak_waiting"], len(self.scheduler.waiting))
        return seq

    def adopt(self, request, generated=None):
        """Enqueue one request salvaged from a dead replica together with
        the tokens it already generated there (the fleet router's
        failover path).  It enters like a preempted requeue: admission
        re-prefills ``prompt + generated`` (mostly page-table lookups
        under a warm prefix cache) and the absolute-step sampling keys
        continue the stream.  The deadline restamps from this enqueue.
        A bounded queue may shed it at once; it then comes back
        terminal."""
        self._validate_requests([request])
        seq = self._enqueue(request, generated=generated)
        if self.scheduler.num_shed:
            self._sync_lifecycle_stats()
        return seq

    def _validate_requests(self, requests):
        # validate EVERYTHING before enqueuing anything: a mid-list
        # reject must not leave earlier requests queued as ghost work
        for req in requests:
            if len(req.prompt) > self.max_context:
                raise ValueError(
                    f"prompt of {len(req.prompt)} tokens exceeds the "
                    f"engine's context of {self.max_context} "
                    "(num_pages * page_size and model.max_seq_len bound "
                    "it); generation past the context is truncated with "
                    'a "capacity" finish instead'
                )
            if not req.prompt:
                raise ValueError("empty prompt")
            if req.max_new_tokens < 1:
                raise ValueError("max_new_tokens must be >= 1")
            if not 0 <= req.seed < 2 ** 31:
                raise ValueError(
                    f"seed {req.seed} out of the int32 sampling-key "
                    "range [0, 2**31)"
                )
            if req.deadline_ms is not None and req.deadline_ms <= 0:
                raise ValueError(
                    f"deadline_ms must be > 0, got {req.deadline_ms!r}"
                )

    def generate(self, requests) -> List[ServeResult]:
        """Run a batch of :class:`Request`s to completion; results come
        back in request order."""
        sched = self.scheduler
        seqs = self.submit(requests)
        t0 = time.perf_counter()
        try:
            self._run_to_completion()
        except BaseException:
            # mid-run failure (device fault, interrupt): detach THIS
            # call's unfinished sequences and free their pages so the
            # engine stays usable
            for seq in seqs:
                if seq.done:
                    continue
                if seq in sched.running:
                    sched.running.remove(seq)
                    self.pool.free(seq.sid)
                elif seq in sched.waiting:
                    sched.waiting.remove(seq)
            raise
        self.stats["wall_time_s"] += time.perf_counter() - t0
        self.stats["evictions"] = sched.num_evictions
        if self.stats["decode_time_s"] > 0:
            self.stats["decode_tokens_per_sec"] = (
                self.stats["decode_tokens"] / self.stats["decode_time_s"]
            )
        # drain this call's sequences from sched.finished: a long-lived
        # engine's memory stays flat across generate() calls
        ours = set(id(s) for s in seqs)
        sched.finished = [s for s in sched.finished if id(s) not in ours]
        return [self._result_of(seq) for seq in seqs]

    @staticmethod
    def _result_of(seq):
        return ServeResult(
            request_id=seq.req.request_id,
            prompt=list(seq.req.prompt),
            tokens=list(seq.generated),
            finish_reason=seq.finish_reason,
            ttft_ms=(
                None if seq.first_token_at is None
                else (seq.first_token_at - seq.enqueued_at) * 1e3
            ),
            evictions=seq.evictions,
        )

    def collect_finished(self) -> List[ServeResult]:
        """Drain every finished sequence into results."""
        done, self.scheduler.finished = self.scheduler.finished, []
        return [self._result_of(seq) for seq in done]

    # -- lifecycle plumbing --------------------------------------------

    def request_drain(self):
        """Programmatic drain trigger — same semantics as SIGTERM
        through a wired :class:`GracefulShutdown`: admission closes at
        the next step boundary, running work gets ``drain_timeout``
        seconds, and the engine stays drained."""
        self._drain_flag = True

    def _drain_requested(self):
        return self._drain_flag or bool(
            self.shutdown is not None and self.shutdown.requested
        )

    def _sync_lifecycle_stats(self):
        self.stats["shed"] = self.scheduler.num_shed
        self.stats["expired"] = self.scheduler.num_expired
        self.stats["prefix_hits"] = self.pool.prefix_stats["hits"]
        self.stats["prefix_tokens_saved"] = (
            self.pool.prefix_stats["tokens_saved"])

    def _fail_capacity(self, seq):
        """A request whose prefix can never fit even an EMPTY pool
        terminates with reason ``"capacity"`` instead of cycling the
        preempt-retry recovery forever."""
        logger.warning(
            "request %r needs %d pages for its %d-token prefix; the "
            "pool holds %d — failing fast with reason 'capacity'",
            seq.req.request_id,
            self.pool.pages_for(len(seq.prefix())), len(seq.prefix()),
            self.pool.num_usable_pages,
        )
        self.scheduler.finish(seq, "capacity")
        self.stats["capacity_failfast"] += 1

    def _run_to_completion(self):
        while self.serve_step():
            pass

    def has_work(self):
        return self.scheduler.has_work()

    def _step_rows(self, todo):
        """Dispatch this step's planned rows: ONE mixed ragged dispatch,
        or (``unified=False``, the A/B baseline) the prefill rows and the
        decode rows as two separate dispatches."""
        rows = self._plan_rows(todo)
        if not rows:
            return
        if self.unified:
            self._dispatch(rows)
            return
        for group in ([r for r in rows if not r[4]],
                      [r for r in rows if r[4]]):
            live = [r for r in group
                    if r[0] in self.scheduler.running and not r[0].done]
            if live:
                self._dispatch(live)

    def _host_fault(self, seqs, phase, exc):
        """A host-side step fault (bad batch assembly, a model error on
        one batch) fails the IN-FLIGHT sequences, not the engine: they
        finish ``"failed"``, their pages free, and the loop continues.
        The pools stay valid — a step writes only the in-flight
        sequences' slots and the trash page."""
        failed = [s for s in seqs
                  if not s.done and s in self.scheduler.running]
        logger.error(
            "host-side %s fault failed %d in-flight request(s): %r",
            phase, len(failed), exc,
        )
        for seq in failed:
            self.scheduler.finish(seq, "failed")
        self.stats["host_faults"] += 1

    def serve_step(self):
        """Advance the engine by ONE scheduler iteration: deadline
        expiry, drain bookkeeping, capacity fail-fast, admission, one
        ragged dispatch (mixed prefill-chunk + decode rows).  Returns
        True while work remains queued."""
        sched = self.scheduler
        if not sched.has_work():
            self._sync_lifecycle_stats()
            self._maybe_finalize_drain()
            self._stalled = 0
            return False
        now = self._clock()
        # deadline expiry at the ADMISSION boundary: a blown
        # request must not take (or keep) pool pages
        expired = bool(sched.expire(now))
        if not self._draining and self._drain_requested():
            self._draining = True
            self._drain_started = now
            # report what the DRAIN cut, not lifetime counters
            self._drain_shed0 = sched.num_shed
            self._drain_expired0 = sched.num_expired
            logger.warning(
                "drain requested: admission closed; shedding %d "
                "waiting request(s), %d running get %.1fs to finish",
                len(sched.waiting), len(sched.running),
                self.drain_timeout,
            )
        shed_now = 0
        if self._draining:
            # admission is closed: what waits now can never run
            for seq in list(sched.waiting):
                sched.finish(seq, "shed")
                shed_now += 1
            if (now - self._drain_started) > self.drain_timeout:
                for seq in list(sched.running):
                    sched.finish(seq, "shed")
                    shed_now += 1
        self._sync_lifecycle_stats()
        if not sched.has_work():
            self._maybe_finalize_drain()
            self._stalled = 0
            return False
        failed_fast = 0
        admitted, did_dispatch = [], False
        try:
            # capacity fail-fast BEFORE admission: a head request
            # that can never fit would otherwise stall the queue
            while (sched.waiting
                   and self.pool.pages_for(
                       len(sched.waiting[0].prefix()))
                   > self.pool.num_usable_pages):
                self._fail_capacity(sched.waiting[0])
                failed_fast += 1
            if not self._draining:
                # admit() hands back fresh AND resumed sequences —
                # their ragged prefill starts past any shared-prefix
                # pages the pool matched
                admitted = sched.admit(
                    bucket=lambda n: min(n, self.prefill_chunk))
                sched.chaos_preempt()
            if sched.running:
                todo = sched.prepare_decode()
                if todo:
                    try:
                        self._step_rows(todo)
                    except DEVICE_FAULTS:
                        raise  # the device path is broken, not a request
                    except Exception as exc:  # host fault isolation
                        self._host_fault(todo, "ragged-step", exc)
                    did_dispatch = True
            # deadline expiry at the DECODE boundary: pages free
            # the moment the deadline blows, not a decode tail later
            expired = bool(sched.expire(self._clock())) or expired
        except PoolExhausted:
            # an admission race got past the can_alloc/extend guards:
            # recoverable — preempt the scheduler's LIFO victim (the
            # requeue-front path organic exhaustion takes) and retry
            # the step on the freed pages
            if not sched.running:
                if sched.waiting and self.pool.is_idle():
                    # even an EMPTY pool cannot hold the head request
                    self._fail_capacity(sched.waiting[0])
                    self._stalled = 0
                    return True
                raise  # pages missing with nothing running: a bug
            sched.preempt(sched._pick_victim())
            self.stats["pool_exhausted_recoveries"] += 1
            self._stalled = 0  # freed pages guarantee the retry runs
            return True
        self.stats["peak_pool_occupancy"] = max(
            self.stats["peak_pool_occupancy"], self.pool.occupancy()
        )
        self.stats["peak_waiting"] = max(
            self.stats["peak_waiting"], len(sched.waiting)
        )
        # an iteration may legitimately emit nothing when its only
        # event was an eviction; two empty iterations in a row mean
        # the scheduler is wedged
        progressed = bool(admitted or did_dispatch or expired
                          or failed_fast or shed_now)
        self._stalled = 0 if progressed else self._stalled + 1
        if self._stalled >= 2 and sched.has_work():
            raise RuntimeError(
                "scheduler stalled with work queued — this is a bug "
                "(the admission guard should make progress "
                "inevitable)"
            )
        if not sched.has_work():
            self._sync_lifecycle_stats()
            self._maybe_finalize_drain()
            self._stalled = 0
            return False
        return True

    def _maybe_finalize_drain(self):
        """Write the drain report once the queue empties while a drain
        is active (the flag stays set — a drained engine sheds whatever
        a later submit enqueues)."""
        if not self._draining:
            return
        drain_ms = (self._clock() - self._drain_started) * 1e3
        signame = None
        if (self.shutdown is not None
                and self.shutdown.signum is not None):
            import signal

            signame = signal.Signals(self.shutdown.signum).name
        self.drain_report = {
            "requested": True,
            "signal": signame,
            "drain_ms": round(drain_ms, 2),
            "drain_timeout_s": self.drain_timeout,
            "shed": self.scheduler.num_shed - self._drain_shed0,
            "expired": self.scheduler.num_expired - self._drain_expired0,
            "deadline_exceeded": drain_ms > self.drain_timeout * 1e3,
            "pool_idle": self.pool.is_idle(),
        }
        self._draining = False
        logger.warning("drain complete: %s", self.drain_report)

    # -- fleet-facing surface ------------------------------------------

    def load_snapshot(self):
        """Cheap router-facing load and health snapshot — a STABLE typed
        dict, the JAX engine's keys and types:

        ``free_pages``/``total_pages`` (int) pool headroom (cached
        prefix pages count as free), ``waiting``/``running`` (int) queue
        depths, ``free_slots`` (int) open decode-batch rows,
        ``max_waiting`` (int or None) the bounded-queue shed line,
        ``draining`` (bool) admission closed, ``step_ms`` (float) median
        of the recent decode-step wall latencies (0.0 before the first
        decode), the prefix-cache surface ``prefix_hits`` (int),
        ``prefix_tokens_saved`` (int), ``prefix_hit_rate`` (float), and
        the health surface: ``last_progress`` (int), the monotonic count
        of tokens this replica has emitted (a replica holding work whose
        watermark does not move for the router's budget is WEDGED), and
        ``host_faults`` (int), the monotonic host-fault counter."""
        sched = self.scheduler
        recent = list(self.decode_ms)[-33:]
        step_ms = float(sorted(recent)[len(recent) // 2]) if recent else 0.0
        ps = self.pool.prefix_stats
        hit_rate = (ps["hits"] / ps["lookups"]) if ps["lookups"] else 0.0
        return {
            "free_pages": int(self.pool.num_free_pages),
            "total_pages": int(self.pool.num_usable_pages),
            "waiting": int(len(sched.waiting)),
            "running": int(len(sched.running)),
            "free_slots": int(max(0, self.max_batch - len(sched.running))),
            "max_waiting": (None if sched.max_waiting is None
                            else int(sched.max_waiting)),
            "draining": bool(self._draining or self._drain_requested()),
            "step_ms": round(step_ms, 4),
            "prefix_hits": int(ps["hits"]),
            "prefix_tokens_saved": int(ps["tokens_saved"]),
            "prefix_hit_rate": round(float(hit_rate), 4),
            "last_progress": int(self.stats["generated_tokens"]),
            "host_faults": int(self.stats["host_faults"]),
        }

    def reclaim_waiting(self, *, include_running=False):
        """Detach and return every WAITING request (rolling restart: the
        router reroutes them before this replica drains; they hold no
        pool pages).

        ``include_running=True`` is the failover salvage: RUNNING
        sequences are force-detached too, and the return value becomes
        ``[(Request, generated), ...]`` — running first, then waiting in
        queue order — for a healthy replica to :meth:`adopt`.  Page
        frees on the dead pool are best-effort."""
        sched = self.scheduler
        if not include_running:
            reqs = [seq.req for seq in sched.waiting]
            sched.waiting.clear()
            return reqs
        salvaged = []
        for seq in list(sched.running):
            salvaged.append((seq.req, list(seq.generated)))
            sched.running.remove(seq)
            try:
                self.pool.free(seq.sid)
            except Exception as e:  # noqa: BLE001 - dying pool, best effort
                logger.warning(
                    "failover salvage: freeing %r on the dead replica's "
                    "pool failed (%s) — the pool leaves with the replica",
                    seq.sid, e,
                )
        salvaged.extend((seq.req, list(seq.generated))
                        for seq in sched.waiting)
        sched.waiting.clear()
        return salvaged

    def reopen(self):
        """Re-open admission after a COMPLETED drain (the router's
        in-place restart).  Refuses on a non-idle pool or queued work."""
        if self.scheduler.has_work() or not self.pool.is_idle():
            raise RuntimeError(
                "reopen() on a busy engine: drain to idle first "
                f"(waiting={len(self.scheduler.waiting)} "
                f"running={len(self.scheduler.running)} "
                f"pool_idle={self.pool.is_idle()})"
            )
        self._drain_flag = False
        self._draining = False
        # the restart's drain record must not pass for a later drain's
        self.drain_report = None
        if self.shutdown is not None and hasattr(self.shutdown, "clear"):
            self.shutdown.clear()  # ChildShutdown: a fleet drain reads through

    # -- live weight swaps ---------------------------------------------

    @property
    def params(self):
        """The tree the engine serves, on the host: the JAX package's
        flax layout of numpy copies (``deploy/loader.py``
        ``load_serve_params`` gives the same layout).  A rollout keeps it
        as the fallback it swaps back on a rollback."""
        return self.model.flax_tree(dict(self.model.named_parameters()))

    def _checked_swap(self, new_params):
        """``new_params`` (a flax-layout tree) as parameter name -> fp32
        CPU tensor, after checking its structure, every leaf's shape
        and dtype against the serving tree; raises
        :class:`WeightSwapError` before anything is written."""
        want = dict(self.model.named_parameters())
        # the host tree's leaves are numpy arrays of the serving dtype
        serving = torch.empty(0, dtype=next(iter(want.values())).dtype)
        serving = serving.numpy().dtype
        for path, leaf in _flax_leaves(new_params):
            dtype = np.asarray(leaf).dtype
            if dtype != serving:
                raise WeightSwapError(
                    f"param leaf {'/'.join(path)} mismatch: engine serves "
                    f"{serving}, swap offered {dtype}")
        try:
            named = self.model.named_from_flax(new_params)
        except (KeyError, ValueError) as e:
            raise WeightSwapError(
                f"param tree structure mismatch: {e}") from e
        if set(named) != set(want):
            raise WeightSwapError(
                "param tree structure mismatch: engine serves "
                f"{sorted(set(want) - set(named))} that the swap lacks, "
                f"swap offered {sorted(set(named) - set(want))} that the "
                "engine does not serve")
        for name, p in want.items():
            if tuple(named[name].shape) != tuple(p.shape):
                raise WeightSwapError(
                    f"param leaf {name} mismatch: engine serves "
                    f"{tuple(p.shape)}/{p.dtype}, swap offered "
                    f"{tuple(named[name].shape)}/{named[name].dtype}")
        return named

    @torch.no_grad()
    def swap_weights(self, new_params):
        """Install ``new_params`` (the flax-layout host tree) between
        serve steps.  The KV pool, the prefix-cache index, page tables
        and every in-flight sequence survive untouched.

        Structure and every leaf's shape and dtype are checked against
        the serving tree first (:class:`WeightSwapError`, nothing
        written).  The new tensors are then staged on the device and
        synced before the cutover, so a failed transfer leaves the old
        weights in place.  Only storage a previous swap placed is
        written in place: the first swap makes the staged tensors this
        engine's own parameters (a module of its own), never touching
        the boot module a sibling replica or the caller may hold; later
        swaps copy into those parameters, so their addresses stay fixed
        and memory holds one param set per replica, never two waiting
        on the allocator.

        Call it at a step boundary, never from inside a dispatch.
        Returns the host-side stall in seconds."""
        named = self._checked_swap(new_params)
        t0 = self._clock()
        staged = {name: t.to(self.device) for name, t in named.items()}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        params = dict(self.model.named_parameters())
        if self._owns_params:
            for name, p in params.items():
                p.copy_(staged[name])
        else:
            # a module of the engine's own whose parameters ARE the
            # staged tensors (deepcopy with them in its memo): nothing
            # the old module's other holders see changes
            memo = {id(p): torch.nn.Parameter(staged[name],
                                              requires_grad=p.requires_grad)
                    for name, p in params.items()}
            self.model = copy.deepcopy(self.model, memo)
        del staged
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._owns_params = True
        self.weight_swaps += 1
        stall = self._clock() - t0
        logger.info("weight swap #%d installed (%d leaves, %.2f ms host "
                    "stall)", self.weight_swaps, len(params), stall * 1e3)
        return stall


def _flax_leaves(tree, prefix=()):
    """``(path, leaf)`` of a nested-dict param tree, depth first."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flax_leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value
