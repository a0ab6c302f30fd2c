"""Epoch/batch iteration for the port's training loop (a copy of
``unicore_tpu/data/iterators.py``).

Multi-epoch iteration over a frozen batch list with deterministic
per-epoch shuffling (``numpy_seed(seed + epoch)``), round-robin
data-parallel sharding padded so every shard sees the same number of
steps (empty batches become ``{}`` dummies), parallel batch
materialization, a background prefetch pump, and mid-epoch checkpoint
resume in the reference's version-2 state dict, with proportional offset
rescaling when the per-shard epoch length changes between runs.

One :class:`_EpochStream` owns a shard's batch plan, cursor, worker pool
and prefetch pump; :class:`EpochBatchIterator` plans epochs and
(de)serializes position.  Two worker-pool implementations
(``set_worker_impl``): ``thread`` (the default: zero-copy, fine for numpy
collation over mmap-backed record stores, GIL-bound for CPU-heavy
transforms) and ``process`` (fork-context worker processes, the
reference's DataLoader-worker model).  Batches stay numpy here: a forked
worker must not touch CUDA, and the trainer moves each batch to the
device.  The seeded masks draw from private ``RandomState`` objects
(``data_utils.seeded_rng``), so every worker count and impl yields the
inline batches bit for bit.
"""

import collections
import itertools
import logging
import queue
import signal
import threading
import time
import multiprocessing
from concurrent.futures import BrokenExecutor, Future, ProcessPoolExecutor, \
    ThreadPoolExecutor

import numpy as np

from . import data_utils

logger = logging.getLogger(__name__)

# a crashed (SIGKILLed/OOM-killed) process-pool worker breaks the whole
# executor; the stream respawns it with position restored, this many
# times, before concluding the crash is deterministic and re-raising
MAX_POOL_RESPAWNS = 3


class CountingIterator:
    """Iterator wrapper tracking an absolute position ``n``.

    ``total`` is the absolute end position; ``skip``/``take`` adjust the
    window.  Building block for resumable iteration.
    """

    def __init__(self, iterable, start=None, total=None):
        self._source = iter(iterable)
        self.n = start if start is not None else getattr(iterable, "n", 0)
        self.total = total if total is not None else self.n + len(iterable)

    def __len__(self):
        return self.total

    def __iter__(self):
        return self

    def __next__(self):
        if self.n >= self.total:
            raise StopIteration
        try:
            value = next(self._source)
        except StopIteration:
            self.total = self.n
            raise
        self.n += 1
        return value

    def has_next(self):
        return self.n < self.total

    def skip(self, count):
        """Advance past ``count`` elements."""
        for _ in itertools.repeat(None, count):
            try:
                next(self)
            except StopIteration:
                break
        return self

    def take(self, n):
        """Cap the absolute end position at ``n``."""
        self.total = min(self.total, n)
        return self


class GroupedIterator(CountingIterator):
    """Yields lists of up to ``chunk_size`` items — the grad-accumulation
    micro-batch groups consumed by ``Trainer.train_step``."""

    def __init__(self, iterable, chunk_size):
        def chunks():
            source = iter(iterable)
            while True:
                group = list(itertools.islice(source, chunk_size))
                if not group:
                    return
                yield group

        super().__init__(
            chunks(),
            start=-(-getattr(iterable, "n", 0) // chunk_size),
            total=-(-len(iterable) // chunk_size),
        )
        self.chunk_size = chunk_size


class ShardedIterator(CountingIterator):
    """Round-robin shard view of an iterable, padded with ``fill_value`` so
    every shard has equal length (the data-parallel lockstep guarantee)."""

    def __init__(self, iterable, num_shards, shard_id, fill_value=None):
        if not 0 <= shard_id < num_shards:
            raise ValueError(
                f"shard_id must be in [0, {num_shards}), got {shard_id}"
            )
        shard_len = -(-len(iterable) // num_shards)

        def sharded():
            mine = itertools.islice(
                iter(iterable), shard_id, None, num_shards
            )
            produced = 0
            for item in mine:
                produced += 1
                yield item
            for _ in range(shard_len - produced):
                yield fill_value

        super().__init__(
            sharded(),
            start=getattr(iterable, "n", 0) // num_shards,
            total=shard_len,
        )


class BufferedIterator(CountingIterator):
    """Bounded background prefetch of an iterator on a daemon thread.

    Thin position-tracking shell over :func:`_prefetch_thread` (one shared
    prefetch implementation); ``take`` truncation propagates to the inner
    iterator so the producer stops early too."""

    def __init__(self, size, iterable):
        self._inner = iterable
        super().__init__(
            _prefetch_thread(iter(iterable), size),
            start=getattr(iterable, "n", 0),
            total=len(iterable),
        )

    def take(self, n):
        super().take(n)
        if hasattr(self._inner, "take"):
            self._inner.take(n)
        return self


class _EpochStream:
    """One shard's batches for one epoch: plan + cursor + materialization.

    ``plan`` is the full per-shard list of index lists (``[]`` entries are
    lockstep padding and materialize as ``{}`` dummy batches); ``n`` is the
    absolute position within the plan, so a stream built at a resume
    offset reports positions consistent with a fresh one.
    """

    def __init__(self, dataset, collate_fn, plan, offset=0, num_workers=0,
                 buffer_size=0):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.plan = plan
        self.n = offset
        self.total = len(plan)
        self.num_workers = num_workers
        self.buffer_size = buffer_size
        self.impl = worker_impl() if num_workers > 0 else "inline"
        self.respawns = 0
        self._iter = None
        self._pump = None
        self._pool = None
        self._inflight_head = None  # dataset indices the consumer awaits
        if num_workers > 0 and self.impl == "process":
            # fork the worker processes HERE, on the construction (main)
            # thread — _produce's generator body runs on the prefetch pump
            # thread when buffer_size > 0, and forking a multithreaded
            # process from a daemon thread is a deadlock window.  The
            # warmup submit forces the lazy fork to happen now.
            self._pool = self._make_pool()

    def _make_pool(self):
        pool = ProcessPoolExecutor(
            max_workers=self.num_workers,
            mp_context=multiprocessing.get_context("fork"),
            initializer=_process_worker_init,
            initargs=(self.dataset, self.collate_fn),
        )
        pool.submit(int, 0).result()
        return pool

    def __len__(self):
        return self.total

    def has_next(self):
        return self.n < self.total

    def __iter__(self):
        return self

    def __next__(self):
        if self._iter is None:
            self._iter = self._produce()
        return next(self._iter)

    def _load(self, indices):
        if len(indices) == 0:
            return {}  # lockstep dummy; trainer assigns it zero weight
        if self.num_workers == 0:
            # inline path only: under the thread pool this method runs
            # on worker threads, and a healthy worker's write here
            # would clobber the consumer-side "awaiting" marker the
            # watchdog dump names (_pooled owns it there)
            self._inflight_head = [int(i) for i in indices]
        # per-batch prefetch: wrapper stacks fan this down to the record
        # store, whose native readahead does the disk IO with the GIL
        # released — the per-item __getitem__ loop below then reads warm
        # pages, so thread workers stop serializing on IO.  Only when
        # thread workers are actually in use: without them there is no
        # GIL contention to relieve and the sweep is pure overhead.
        if (
            self.num_workers > 0
            and worker_impl() == "thread"
            and getattr(self.dataset, "supports_prefetch", False)
        ):
            self.dataset.prefetch(indices)
        return self.collate_fn([self.dataset[int(i)] for i in indices])

    def _produce(self):
        todo = self.plan[self.n:]
        if self.num_workers > 0:
            source = self._pooled(todo)
        else:
            source = map(self._load, todo)
        if self.buffer_size > 0:
            self._pump = _PrefetchPump(source, self.buffer_size)
            source = iter(self._pump)
        for batch in source:
            self.n += 1
            yield batch

    def status(self):
        """One-line pipeline state for the step watchdog's timeout dump:
        names the worker impl and the dataset indices of the batch the
        consumer is stuck waiting on."""
        bits = [f"impl={self.impl}", f"workers={self.num_workers}",
                f"batch={self.n}/{self.total}"]
        head = self._inflight_head
        if head is not None:
            bits.append(f"awaiting_indices={head[:12]}")
        if self.respawns:
            bits.append(f"respawns={self.respawns}")
        if self._pump is not None:
            bits.append(self._pump.status())
        return "input(" + " ".join(bits) + ")"

    def close(self, timeout=5.0):
        """Tear the pipeline down within ``timeout`` seconds, leak-free
        (graceful-shutdown path: a preemption save must not leave orphan
        worker processes or a wedged prefetch pump behind to be
        hard-killed by the supervisor after the grace window).  Order
        matters: killing the pool first turns a pump blocked inside
        ``future.result()`` into an exception it can exit on."""
        deadline = time.monotonic() + timeout
        if self._pool is not None:
            pool, self._pool = self._pool, None  # _pooled: None = closed
            # snapshot the worker processes BEFORE shutdown clears the
            # executor's table, so the terminate/join sweep below can
            # actually reap them within the deadline
            procs = list((getattr(pool, "_processes", None) or {}).values())
            pool.shutdown(wait=False, cancel_futures=True)
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            for p in procs:
                if p.is_alive():  # wedged in an uninterruptible read
                    p.kill()
                    p.join(1.0)
        if self._pump is not None:
            pump, self._pump = self._pump, None
            pump.stop(max(0.1, deadline - time.monotonic()))
        if self._iter is not None:
            # run _pooled's finally (thread-pool shutdown).  A generator
            # mid-execution on the (now stopping) pump thread refuses
            # close() with ValueError — the pump is already down and the
            # daemon thread pool cannot outlive its cancelled futures.
            it, self._iter = self._iter, None
            try:
                it.close()
            except (ValueError, RuntimeError):
                pass

    def _pooled(self, todo):
        """Materialize with a worker pool, at most ~2x workers in flight so
        loading can't run an entire epoch ahead of the consumer.

        Two pool implementations (``set_worker_impl``):

        - ``thread`` (default): zero-copy, fine for IO-bound pipelines
          (LMDB/record byte reads) but GIL-bound for CPU-heavy transforms;
        - ``process``: fork-context worker PROCESSES (the reference's
          DataLoader-worker model, ``unicore/data/iterators.py:389-395``)
          — the dataset/collater ship to each worker once via the pool
          initializer, per-batch traffic is index lists in and pickled
          numpy batches out, and each batch carries the worker's
          data-guard skip decisions back for the main process to commit
          (``GuardedDataset.commit_health``).  A crashed worker (OOM
          kill, segfault) breaks the executor: the stream respawns it —
          bounded by MAX_POOL_RESPAWNS — and resubmits every
          not-yet-yielded batch in order, so the consumer's position is
          restored exactly.  Use for tokenize-heavy pipelines.
        """
        window = 2 * self.num_workers
        use_process = self._pool is not None  # forked at __init__
        if use_process:
            submit = self._submit_process
        else:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            submit = lambda b: pool.submit(self._load, b)
        try:
            backlog = iter(todo)
            inflight = collections.deque(
                (submit(b), b) for b in itertools.islice(backlog, window)
            )
            while inflight:
                fut, batch_indices = inflight[0]
                self._inflight_head = [int(i) for i in batch_indices]
                try:
                    res = fut.result()
                except BrokenExecutor as e:
                    if not use_process or self._pool is None:
                        raise  # thread impl, or close() tore the pool down
                    inflight = self._recover(inflight, submit, e)
                    continue
                inflight.popleft()
                nxt = next(backlog, None)
                if nxt is not None:
                    inflight.append((submit(nxt), nxt))
                if use_process and self._pool is not None:
                    # a pool that broke behind the head of the window (a
                    # worker killed while idle, or mid-batch on a later
                    # batch) is respawned now, not when its failed batch
                    # reaches the head
                    broken = next((f for f, _ in inflight if _broken(f)),
                                  None)
                    if broken is not None:
                        inflight = self._recover(inflight, submit,
                                                 broken.exception())
                if use_process:
                    batch, health = res
                    if health is not None:
                        commit = getattr(self.dataset, "commit_health", None)
                        if commit is not None:
                            commit(health)
                    yield batch
                else:
                    yield res
        finally:
            if not use_process:
                pool.shutdown(wait=False, cancel_futures=True)

    def _recover(self, inflight, submit, cause):
        """Respawn the broken pool (``cause`` re-raised once
        MAX_POOL_RESPAWNS are spent); position restored: every batch of
        the window it had not loaded goes to the new pool, in order."""
        if self.respawns >= MAX_POOL_RESPAWNS:
            raise cause
        self._respawn_pool()
        return collections.deque(
            (f, b) if _loaded(f) else (submit(b), b) for f, b in inflight
        )

    def _submit_process(self, indices):
        """Submit one batch to the process pool.  A pool that broke while
        no batch was in flight (a worker killed between batches) refuses
        the submit itself: the refusal comes back as the batch's future,
        which ``_pooled`` finds broken, and the pool respawns with
        position restored."""
        fut = Future()
        pool = self._pool
        if pool is None:  # close() tore the pool down
            fut.set_exception(BrokenExecutor("the data worker pool is "
                                             "closed"))
            return fut
        try:
            return pool.submit(_process_worker_load,
                               [int(i) for i in indices])
        except BrokenExecutor as e:
            fut.set_exception(e)
            return fut

    def _respawn_pool(self):
        """Re-fork the process pool after a worker crash.  Forking from
        the pump thread is the accepted risk here: recovery beats
        purity, and the alternative is killing a run a supervisor would
        restart from scratch anyway."""
        self.respawns += 1
        logger.warning(
            "data worker pool broke (crashed worker process); respawning "
            "%d/%d with position restored", self.respawns,
            MAX_POOL_RESPAWNS,
        )
        old, self._pool = self._pool, None
        old.shutdown(wait=False, cancel_futures=True)
        self._pool = self._make_pool()


def _broken(fut):
    """A batch's future failed by a broken (or closed) pool."""
    return (fut.done() and not fut.cancelled()
            and isinstance(fut.exception(), BrokenExecutor))


def _loaded(fut):
    """A batch the pool finished before it broke: its result stands."""
    return fut.done() and not fut.cancelled() and fut.exception() is None


_WORKER_IMPL = "thread"
_PROCESS_WORKER = {"dataset": None, "collate": None}


def set_worker_impl(impl):
    """Select the data-worker pool implementation: ``thread`` | ``process``
    (``--worker-impl``; consulted when ``num_workers > 0``)."""
    global _WORKER_IMPL
    if impl not in ("thread", "process"):
        raise ValueError(f"unknown worker impl {impl!r}")
    _WORKER_IMPL = impl


def worker_impl():
    return _WORKER_IMPL


def _process_worker_init(dataset, collate_fn):
    # a forked worker inherits the trainer's signal handlers (the
    # graceful shutdown only sets a flag): SIGTERM must end the worker so
    # close() can reap it, and SIGINT (a terminal's Ctrl-C reaches the
    # whole process group) is the parent's to handle
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    # runs INSIDE the worker.  A fork-context worker inherits the
    # dataset as a memory COPY — __getstate__ never runs — so any
    # canonical skip log came along for the ride; worker_init detaches
    # it, making decisions buffer in the relay (_pending) instead of
    # vanishing into the copy.
    worker_init = getattr(dataset, "worker_init", None)
    if worker_init is not None:
        worker_init()
    _PROCESS_WORKER["dataset"] = dataset
    _PROCESS_WORKER["collate"] = collate_fn


def _process_worker_load(indices):
    """Returns ``(batch, health)``: the collated batch plus the worker's
    drained data-guard decisions (skip entries + fetch/retry counts) for
    the main process to fold into the canonical skip log — a forked
    worker's ``GuardedDataset`` copy has no view of the global budget."""
    ds = _PROCESS_WORKER["dataset"]
    if len(indices) == 0:
        return {}, None  # lockstep dummy; trainer assigns it zero weight
    batch = _PROCESS_WORKER["collate"]([ds[i] for i in indices])
    drain = getattr(ds, "drain_health", None)
    return batch, (drain() if drain is not None else None)


_PUMP_DONE = object()


class _PrefetchPump:
    """Bounded background prefetch of an iterator on a daemon thread.

    The supervised version of the old ``_prefetch_thread`` closure:
    ``stop()`` tears it down within a deadline (the graceful-shutdown
    leak-free contract — a blocked ``put`` unblocks via a stop-aware
    timeout loop plus a consumer-side drain), and ``status()`` reports
    depth/progress/idle time for the step watchdog's timeout dump."""

    def __init__(self, source, depth, name="unicore-data-prefetch"):
        self._source = source
        self._q = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self.items = 0
        self.last_put = time.monotonic()
        self._thread = threading.Thread(
            target=self._pump, daemon=True, name=name
        )
        self._thread.start()

    def _put(self, item):
        """Queue.put that gives up when stop() was requested."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _pump(self):
        try:
            for item in self._source:
                if not self._put(item):
                    return
                self.items += 1
                self.last_put = time.monotonic()
        except Exception as e:
            self._put(e)
            return
        self._put(_PUMP_DONE)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _PUMP_DONE:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def status(self):
        idle = time.monotonic() - self.last_put
        return (
            f"prefetch(depth={self._q.qsize()} produced={self.items} "
            f"idle={idle:.1f}s alive={self._thread.is_alive()})"
        )

    def stop(self, timeout=5.0):
        """Signal the pump down and join it; drains the queue so a
        blocked producer-side ``put`` unblocks.  Returns True when the
        thread exited within the deadline (a worker wedged inside the
        source cannot be interrupted — the daemon thread is abandoned
        and the caller's deadline still holds)."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        return not self._thread.is_alive()


def _prefetch_thread(source, depth):
    """Generator view of ``source`` pumped by a daemon thread."""
    return iter(_PrefetchPump(source, depth))


class EpochBatchIterator:
    """Checkpointable multi-epoch iterator over a frozen batch list.

    Each epoch: (re)shuffle the global batch list under
    ``numpy_seed(seed + epoch)``, slice out this worker's round-robin
    shard (padded to lockstep length), and stream it through a
    :class:`_EpochStream`.  ``state_dict``/``load_state_dict`` carry the
    epoch and the in-epoch position, rescaling the position
    proportionally when the per-shard epoch length changed (e.g. a resume
    at a different world size).
    """

    def __init__(self, dataset, collate_fn, batch_sampler, seed=1,
                 num_shards=1, shard_id=0, num_workers=0, epoch=1,
                 buffer_size=0, timeout=0, disable_shuffling=False):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_sampler = batch_sampler
        self._global_batches = (
            None if callable(batch_sampler) else tuple(batch_sampler)
        )
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.num_workers = num_workers
        self.buffer_size = min(buffer_size, 32)
        self.disable_shuffling = disable_shuffling

        self.epoch = max(epoch, 1)
        self.shuffle = not disable_shuffling
        self._active = None  # current epoch's stream
        self._resumed = None  # stream prebuilt by load_state_dict

    # -- batch planning ------------------------------------------------

    @property
    def frozen_batches(self):
        if self._global_batches is None:
            self._global_batches = tuple(
                self.batch_sampler(self.dataset, self.epoch)
            )
        return self._global_batches

    @property
    def first_batch(self):
        """A materialized prototype batch (shape/dtype reference)."""
        if len(self.frozen_batches) == 0:
            raise Exception(
                "empty dataset (every sample may have been filtered out)"
            )
        return self.collate_fn(
            [self.dataset[int(i)] for i in self.frozen_batches[0]]
        )

    def _shard_plan(self, epoch, shuffle):
        """This worker's padded batch list for ``epoch``."""
        batches = list(self.frozen_batches)
        if shuffle:
            with data_utils.numpy_seed(self.seed + epoch):
                order = np.random.permutation(len(batches))
            batches = [batches[i] for i in order]
        mine = batches[self.shard_id::self.num_shards]
        mine += [[]] * (len(self) - len(mine))  # lockstep padding
        return mine

    def _open_stream(self, epoch, shuffle, offset=0):
        plan = self._shard_plan(epoch, shuffle)
        if offset > 0 and offset >= len(plan):
            return None
        # prefetch happens PER BATCH in _EpochStream._load (an epoch-wide
        # warm here would read the whole shard by file offset — wrong
        # order under shuffling, and stalls the epoch open)
        return _EpochStream(
            self.dataset, self.collate_fn, plan, offset=offset,
            num_workers=self.num_workers, buffer_size=self.buffer_size,
        )

    # -- epoch protocol ------------------------------------------------

    def __len__(self):
        return -(-len(self.frozen_batches) // self.num_shards)

    @property
    def n(self):
        return self.iterations_in_epoch

    @property
    def iterations_in_epoch(self):
        if self._active is not None:
            return self._active.n
        if self._resumed is not None:
            return self._resumed.n
        return 0

    @property
    def next_epoch_idx(self):
        if self._resumed is not None:
            return self.epoch
        if self._active is not None and self.end_of_epoch():
            return self.epoch + 1
        return self.epoch

    def next_epoch_itr(self, shuffle=True):
        if self.disable_shuffling:
            shuffle = False
        self.epoch = self.next_epoch_idx
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        if self._active is not None:
            # the finished (or abandoned) epoch's pool and pump go before
            # the next epoch's open: one epoch's workers at a time
            self._active.close()
        if self._resumed is not None:
            self._active, self._resumed = self._resumed, None
        else:
            if callable(self.batch_sampler):
                self._global_batches = None  # refresh for the new epoch
            self._active = self._open_stream(self.epoch, shuffle)
        self.shuffle = shuffle
        return self._active

    def end_of_epoch(self) -> bool:
        return self._active is not None and not self._active.has_next()

    def close(self, timeout=5.0):
        """Shut down the active/resumed streams' worker pools and
        prefetch pumps within a deadline (called by the train loop on
        graceful preemption exit — the grace window is for persisting
        state, not for waiting on wedged workers)."""
        for stream in (self._active, self._resumed):
            if stream is not None:
                stream.close(timeout)

    def status(self):
        """Input-pipeline state line for the step watchdog's timeout
        dump (worker impl, position, awaited dataset indices)."""
        stream = self._active or self._resumed
        if stream is None:
            return f"input(idle epoch={self.epoch})"
        return stream.status()

    # -- checkpoint state ----------------------------------------------

    def state_dict(self):
        if self.end_of_epoch():
            epoch, position = self.epoch + 1, 0
        else:
            epoch, position = self.epoch, self.iterations_in_epoch
        state = {
            "version": 2,
            "epoch": epoch,
            "iterations_in_epoch": position,
            "shuffle": self.shuffle,
            "len": len(self),
        }
        # the data guard's skip log rides the checkpoint: a resumed run
        # must carry the same budget arithmetic and (epoch, index) dedup
        # set, or replayed skips would double-count and the chaos
        # harness's oracle comparison would drift
        skip_log = getattr(self.dataset, "skip_log", None)
        if skip_log is not None:
            state["data_guard"] = skip_log.state_dict()
        return state

    def load_state_dict(self, state_dict):
        self.epoch = state_dict["epoch"]
        skip_log = getattr(self.dataset, "skip_log", None)
        if skip_log is not None and "data_guard" in state_dict:
            # BEFORE the stream is built below: the process worker fork
            # snapshots the dataset, and the main-process log must hold
            # the saved entries before any resumed batch commits new ones
            skip_log.load_state_dict(state_dict["data_guard"])
        position = state_dict.get("iterations_in_epoch", 0)
        saved_len = state_dict.get("len")
        if saved_len not in (None, len(self)) and position > 0:
            # per-shard epoch length changed (world size / batching changed
            # between runs): keep the same fraction of the epoch consumed
            rescaled = int(round(position * len(self) / float(saved_len)))
            logger.info(
                "epoch length changed (%d -> %d); resume position %d -> %d",
                saved_len, len(self), position, rescaled,
            )
            position = rescaled
        if position > 0:
            # epoch state must be applied BEFORE the stream is built:
            # _EpochStream.__init__ forks the process worker pool (under
            # --worker-impl process), snapshotting the dataset — forking
            # first would bake stale epoch-1 masking/shuffle state into
            # every resumed worker
            if hasattr(self.dataset, "set_epoch"):
                self.dataset.set_epoch(self.epoch)
            self._resumed = self._open_stream(
                self.epoch, state_dict.get("shuffle", True), offset=position
            )
            if self._resumed is None:
                if state_dict.get("version", 1) == 1:
                    self.epoch += 1  # legacy: epoch finished exactly at save
                else:
                    raise RuntimeError(
                        "cannot resume: saved position is past the end of "
                        "the epoch; relaunch with --reset-dataloader"
                    )
        else:
            self._resumed = None
