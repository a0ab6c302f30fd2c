"""Continuous batching: admission, interleaving, and eviction policy.

A copy of ``unicore_tpu/serve/scheduler.py`` (the port imports nothing
of the JAX package).  The scheduler is pure host logic over the
:class:`PagedKVPool` — no tensors anywhere — so its central property is
testable with randomized traces:
**no request's tokens are ever lost or duplicated.**  The engine owns
the device work; the scheduler decides, per step, which sequences
prefill, which decode, and which get preempted.

Policy (the shape that wins on TPU per the Gemma serving comparison,
arxiv 2605.25645: keep the decode batch full, amortize prefill between
decode steps under a token budget):

- Each engine step first ADMITS waiting requests — newest-request-last —
  while there is a free decode slot, the pool can hold the prompt's
  pages (shared-prefix pages are credited: the pool dedups them by
  reference), and the step's prefill-token budget is not exhausted
  (cost = the request's first ragged chunk, so the budget caps
  concurrent prefill width; a prompt longer than the whole budget is
  admitted alone rather than starved).  Then every running sequence
  takes a row in the engine's unified ragged dispatch — decode-ready
  sequences a single-token row, prefilling ones a chunk of their
  prompt.
- Pool exhaustion when a sequence crosses a page boundary PREEMPTS the
  most recently admitted running sequence (LIFO victim: it has the
  least sunk decode work).  Preemption frees the pages and requeues the
  request at the FRONT of the waiting queue with its generated tokens
  intact; on re-admission it re-prefills prompt + generated and
  continues — with seeded sampling keyed by absolute step index, the
  continuation is token-identical to an uninterrupted run.
- Termination: EOS (``"eos"``), ``max_new_tokens`` (``"length"``),
  context capacity (``"capacity"``), a blown deadline (``"expired"``),
  overload shedding (``"shed"``), or a per-request fault (``"failed"``,
  the engine's quarantine path).

Robustness policy:

- **Deadlines.**  A request may carry ``deadline_ms`` (TTL from
  enqueue); :meth:`expire` retires blown requests at admission and at
  every decode boundary, freeing their pages immediately — a request
  nobody is waiting for anymore must not hold pool capacity.
- **Overload shedding.**  ``max_waiting`` bounds the waiting queue,
  with free decode slots counted as headroom (an idle engine admits
  ``max_batch + max_waiting`` before shedding; a saturated one holds
  the line at exactly ``max_waiting``); past the bound :meth:`add`
  SHEDS deterministically instead of growing without bound
  (reject-newest by default; ``shed_policy`` is the hook for
  priority-aware policies later).  A shed request finishes immediately
  with reason ``"shed"`` — backpressure the caller can see beats an
  invisible queue that blows every deadline behind it.
- **Starvation protection.**  LIFO preemption alone can evict the same
  long prompt forever (every re-prefill makes it the newest again).
  Each sequence carries a re-prefill budget (``request_retries``):
  once its evictions reach the budget it is PROMOTED — the organic
  victim scan and chaos preemption both skip it — so an admitted
  request's eviction count is bounded and it eventually finishes.
  Requeue-at-front preserves age priority on the admission side.

``chaos_rate`` injects random preemptions (seeded) — the scheduler
property tests force evictions through it instead of hoping a trace
happens to exhaust the pool.
"""

import dataclasses
from collections import deque
from typing import List, Optional

from .kv_pool import PoolExhausted

DEFAULT_REQUEST_RETRIES = 8


@dataclasses.dataclass
class Request:
    """One generation request (all sampling state is explicit so a
    result is reproducible from the request alone).  ``deadline_ms`` is
    a TTL measured from enqueue; ``None`` means no deadline."""

    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    eos_id: Optional[int] = None
    request_id: Optional[str] = None
    deadline_ms: Optional[float] = None


class Sequence:
    """Scheduler-side state of one request."""

    def __init__(self, sid, req):
        self.sid = sid
        self.req = req
        self.generated: List[int] = []
        self.evictions = 0
        self.enqueued_at = None  # host clocks are the engine's job
        self.first_token_at = None
        self.finish_reason = None
        # tokens whose KV is already written to pool pages (set to the
        # pool's shared-prefix credit at admission; the engine advances
        # it one ragged chunk per step — a sequence is decode-ready when
        # prefilled == len(prefix()) - no missing KV but the newest
        # token's)
        self.prefilled = 0
        self.prefix_registered = False

    def prefix(self):
        """Tokens whose KV must be live before the next decode step can
        run (prompt + everything generated so far)."""
        return list(self.req.prompt) + self.generated

    @property
    def done(self):
        return self.finish_reason is not None

    def deadline_blown(self, now):
        """True when the request's TTL has elapsed at host time ``now``
        (same clock that stamped ``enqueued_at``)."""
        return (self.req.deadline_ms is not None
                and self.enqueued_at is not None
                and (now - self.enqueued_at) * 1e3 > self.req.deadline_ms)


def reject_newest(scheduler, incoming):
    """Default shed policy: the incoming request is the victim.  Purely
    deterministic — same arrival order, same shed decisions — which is
    what the overload chaos leg asserts run to run."""
    del scheduler
    return incoming


class Scheduler:
    def __init__(self, pool, max_batch, prefill_token_budget=512,
                 chaos_rate=0.0, chaos_rng=None, max_waiting=None,
                 request_retries=DEFAULT_REQUEST_RETRIES,
                 shed_policy=None):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.prefill_token_budget = int(prefill_token_budget)
        self.chaos_rate = float(chaos_rate)
        self.chaos_rng = chaos_rng
        self.max_waiting = None if max_waiting is None else int(max_waiting)
        self.request_retries = int(request_retries)
        self.shed_policy = shed_policy or reject_newest
        self.waiting = deque()
        self.running: List[Sequence] = []
        self.finished: List[Sequence] = []
        self.num_evictions = 0
        self.num_shed = 0
        self.num_expired = 0
        self._next_sid = 0

    # -- queue management ---------------------------------------------

    def add(self, req, *, generated=None):
        """Enqueue a request; rejects requests that could NEVER run
        (a prompt alone outgrowing the pool) instead of livelocking the
        eviction loop on them later.  Generation beyond the pool is NOT
        rejected — the engine truncates those with a "capacity" finish,
        so a sequence's live KV never exceeds what a solo run fits.

        ``generated``: tokens the request already produced on another
        replica (a failed-over sequence, engine
        :meth:`~unicore_tpu_torch.serve.engine.ServeEngine.adopt`).  It
        enqueues like a preempted requeue: admission re-prefills
        prompt + generated and the absolute-step sampling keys continue
        the stream.  The could-never-run guard covers that whole
        prefix, so a salvage that outgrows THIS pool is rejected here."""
        prefix_len = len(req.prompt) + len(generated or ())
        need = self.pool.pages_for(prefix_len)
        if need > self.pool.num_usable_pages:
            raise ValueError(
                f"prefix needs {need} pages for {prefix_len} tokens "
                f"({len(req.prompt)} prompt); the pool holds "
                f"{self.pool.num_usable_pages} — raise num_pages or "
                "shorten the prompt"
            )
        if not req.prompt:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(
                "max_new_tokens must be >= 1 (prefill always samples "
                "the first token)"
            )
        if req.deadline_ms is not None and req.deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {req.deadline_ms!r} "
                "(use None for no deadline)"
            )
        seq = Sequence(self._next_sid, req)
        self._next_sid += 1
        if generated:
            seq.generated = list(generated)
        # free decode slots count as headroom: a bound that shed while
        # the batch sat idle would throttle capacity, not overload.
        # Saturated (running == max_batch) the bound is exactly
        # max_waiting; the transient above it is the portion the next
        # admission boundary immediately drains into the batch.
        if (self.max_waiting is not None
                and len(self.waiting) >= self.max_waiting
                + max(0, self.max_batch - len(self.running))):
            victim = self.shed_policy(self, seq)
            if victim is not seq:
                # a policy chose a queued victim over the newcomer:
                # shed it and take the newcomer in its place
                self.finish(victim, "shed")
                self.waiting.append(seq)
            else:
                self.finish(seq, "shed")
            return seq
        self.waiting.append(seq)
        return seq

    def expire(self, now):
        """Retire every waiting/running sequence whose deadline has
        blown at host time ``now``, freeing running sequences' pages
        immediately.  Returns the expired sequences.  The engine calls
        this at admission and at every decode boundary — expiry must
        never wait behind a long decode tail."""
        expired = []
        for seq in list(self.running) + list(self.waiting):
            if seq.deadline_blown(now):
                self.finish(seq, "expired")
                expired.append(seq)
        return expired

    def has_work(self):
        return bool(self.waiting or self.running)

    # -- one engine step ----------------------------------------------

    def admit(self, bucket=None):
        """Admit waiting sequences for prefill this step (allocating
        their pool pages, shared-prefix pages by reference).
        ``bucket``: maps a prefix length to this step's admission cost
        in prefill tokens (the engine passes its first-chunk size, so
        the budget caps concurrent prefill width, not total prompt
        length).  Returns the admitted sequences in admission order."""
        bucket = bucket or (lambda n: n)
        admitted = []
        budget = self.prefill_token_budget
        while self.waiting and len(self.running) < self.max_batch:
            seq = self.waiting[0]
            cost = bucket(len(seq.prefix()))
            if admitted and cost > budget:
                break
            if not self.pool.can_alloc(len(seq.prefix()),
                                       tokens=seq.prefix()):
                break
            # alloc BEFORE popping: if the pool raises anyway (an
            # admission race the can_alloc check missed), the sequence
            # is still at waiting[0] — nothing is lost from either
            # queue.  With earlier admissions this call, swallow the
            # raise and return the partial batch (the caller must
            # prefill those; an escaping exception would strand them in
            # `running` with allocated-but-never-written KV pages).
            # Only an EMPTY admission re-raises, for the engine's
            # preempt-a-victim-and-retry recovery — so a PoolExhausted
            # escaping admit() guarantees no half-admitted state.
            try:
                self.pool.alloc(seq.sid, len(seq.prefix()),
                                tokens=seq.prefix())
            except PoolExhausted:
                if admitted:
                    break
                raise
            # shared-prefix credit: the matched pages' KV already
            # exists, so the ragged prefill starts past them
            seq.prefilled = self.pool.cached_tokens(seq.sid)
            self.waiting.popleft()
            self.running.append(seq)
            admitted.append(seq)
            budget -= cost
        return admitted

    def chaos_preempt(self):
        """Randomly preempt one running sequence (seeded test hook).
        Promoted sequences (re-prefill budget exhausted) are exempt —
        the starvation bound must hold under chaos too."""
        if (self.chaos_rng is not None and self.chaos_rate > 0.0
                and self.running
                and self.chaos_rng.random() < self.chaos_rate):
            victims = [s for s in self.running
                       if s.evictions < self.request_retries]
            if not victims:
                return None
            victim = victims[self.chaos_rng.randrange(len(victims))]
            self.preempt(victim)
            return victim
        return None

    def prepare_decode(self):
        """Grow every running sequence's pool length to cover its
        current prefix (a decode-ready sequence grows by one — the
        token this step writes; a mid-prefill sequence is already
        covered by its admission alloc), evicting LIFO on exhaustion.
        Returns the sequences that take a row in this step's ragged
        dispatch."""
        for seq in list(self.running):
            if seq not in self.running:
                continue  # evicted by an earlier iteration
            while True:
                grow = len(seq.prefix()) - self.pool.seq_len(seq.sid)
                if grow <= 0:
                    break
                try:
                    self.pool.extend(seq.sid, grow)
                    break
                except PoolExhausted:
                    victim = self._pick_victim()
                    self.preempt(victim)
                    if victim is seq:
                        break
        return list(self.running)

    def _pick_victim(self):
        """LIFO among sequences still under their re-prefill budget:
        the most recently admitted loses the least sunk work.  A
        sequence that already paid ``request_retries`` re-prefills is
        promoted past the scan — without this, a long prompt is evicted
        the moment it re-admits (its re-prefill makes it the newest
        again) and starves forever.  If EVERY running sequence is
        promoted the newest one is evicted anyway: liveness beats the
        budget, and requeue-at-front still bounds how long it waits."""
        for seq in reversed(self.running):
            if seq.evictions < self.request_retries:
                return seq
        return self.running[-1]

    def preempt(self, seq):
        """Free the sequence's pages and requeue it (front: it keeps its
        age priority).  Its generated tokens stay with it — nothing is
        lost, and re-prefilling prompt+generated re-creates exactly the
        KV state the eviction dropped (a warm prefix cache turns most of
        that re-prefill back into a page-table lookup)."""
        self.pool.free(seq.sid)
        self.running.remove(seq)
        self.waiting.appendleft(seq)
        seq.prefilled = 0
        seq.prefix_registered = False
        seq.evictions += 1
        self.num_evictions += 1

    def finish(self, seq, reason):
        """Terminal transition from EITHER queue (or neither — an
        add-time shed was never enqueued): a running sequence's pages
        are freed; waiting sequences hold none."""
        if seq in self.running:
            self.pool.free(seq.sid)
            self.running.remove(seq)
        elif seq in self.waiting:
            self.waiting.remove(seq)
        seq.finish_reason = reason
        self.finished.append(seq)
        if reason == "shed":
            self.num_shed += 1
        elif reason == "expired":
            self.num_expired += 1
