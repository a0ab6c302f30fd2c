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

Not ported yet: temperature/top-k sampling (a request with
``temperature > 0`` is refused), the step watchdog, the autotuner's
prefill-chunk lookup, live weight swaps, the fleet hooks and the static
and determinism audit surfaces.
"""

import dataclasses
import logging
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops.build import KernelError
from .attention import PagedMeta
from .kv_pool import PagedKVPool, PoolExhausted
from .sampling import finite_rows, greedy_tokens
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
    # "eos" | "length" | "capacity" | "expired" | "shed" | "failed"
    finish_reason: str
    ttft_ms: Optional[float]   # None when no token was ever emitted
    evictions: int


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
                 prefill_chunk=0, prefix_cache=True, chaos_rate=0.0,
                 chaos_rng=None, max_waiting=None,
                 request_retries=DEFAULT_REQUEST_RETRIES,
                 drain_timeout=30.0, shutdown=None, poison_requests=None):
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
        self.drain_timeout = float(drain_timeout)
        self.shutdown = shutdown
        self.drain_report = None
        self._drain_flag = False
        self._drain_started = None
        self._draining = False
        self._drain_shed0 = 0
        self._drain_expired0 = 0
        self._stalled = 0
        # seeded poisoned-request injection (the quarantine test hook):
        # listed request ids get their sampled-from logits row NaN'd
        # inside the step
        self._poison_ids = frozenset(poison_requests or ())
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

    @torch.no_grad()
    def _step(self, tokens, positions, tables, slot_mapping, lengths,
              last_col, poison):
        """Run the model over one ragged batch (numpy host arrays) and
        pick each row's next token from its LAST real column's logits.
        Returns host arrays ``(tokens [B], finite [B])``."""
        dev = self.device
        meta = PagedMeta(
            page_table=torch.from_numpy(tables).to(dev),
            slot_mapping=torch.from_numpy(slot_mapping).to(dev),
            lengths=torch.from_numpy(lengths).to(dev),
            page_size=self.page_size, kv_pages=self.pages,
        )
        x = self.model.features(
            torch.from_numpy(tokens).to(dev),
            positions=torch.from_numpy(positions).to(dev), paged=meta,
        )
        rows = x[torch.arange(x.shape[0], device=dev),
                 torch.from_numpy(last_col).to(dev)]
        logits = self.model.head(rows)
        if poison is not None:  # chaos injection
            logits = torch.where(torch.from_numpy(poison).to(dev)[:, None],
                                 torch.full_like(logits, float("nan")),
                                 logits)
        out = torch.stack([greedy_tokens(logits),
                           finite_rows(logits).long()]).cpu().numpy()
        return out[0], out[1].astype(bool)

    def _width_for(self, chunk):
        """Step width for a step whose widest row carries ``chunk``
        tokens: 1 when every row is a single token, the prefill chunk
        otherwise."""
        return 1 if chunk <= 1 else self.prefill_chunk

    # -- host-side step assembly ---------------------------------------

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
        t0 = time.perf_counter()
        toks, ok = self._step(tokens, positions, tables, slot_mapping,
                              lengths, last_col, poison)
        dt = time.perf_counter() - t0
        self.stats["ragged_dispatches"] += 1
        self.stats["prefills"] += sum(1 for r in rows if not r[4])
        if any_decode:
            self.stats["decode_time_s"] += dt
            self.decode_ms.append(dt * 1e3)
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += sum(1 for r in rows if r[4])
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
            seq.first_token_at = time.perf_counter()
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
        driving them; returns the scheduler's Sequence handles.  A
        bounded queue may shed some of them immediately; the shed
        sequences come back terminal."""
        self._validate_requests(requests)
        seqs = []
        for req in requests:
            seq = self.scheduler.add(req)
            seq.enqueued_at = time.perf_counter()
            self.stats["peak_waiting"] = max(
                self.stats["peak_waiting"], len(self.scheduler.waiting))
            seqs.append(seq)
        if self.scheduler.num_shed:
            self._sync_lifecycle_stats()
        return seqs

    def _validate_requests(self, requests):
        # validate EVERYTHING before enqueuing anything: a mid-list
        # reject must not leave earlier requests queued as ghost work
        for req in requests:
            if req.temperature > 0:
                raise NotImplementedError(
                    f"request {req.request_id!r}: temperature/top-k "
                    "sampling is not ported yet (it needs a counter-"
                    "based per-(seed, step) generator); only greedy "
                    "requests (temperature 0) are served"
                )
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
            while self.serve_step():
                pass
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
        now = time.perf_counter()
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
                        rows = self._plan_rows(todo)
                        if rows:
                            self._dispatch(rows)
                    except DEVICE_FAULTS:
                        raise  # the device path is broken, not a request
                    except Exception as exc:  # host fault isolation
                        self._host_fault(todo, "ragged-step", exc)
                    did_dispatch = True
            # deadline expiry at the DECODE boundary: pages free
            # the moment the deadline blows, not a decode tail later
            expired = bool(sched.expire(time.perf_counter())) or expired
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
        drain_ms = (time.perf_counter() - self._drain_started) * 1e3
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
