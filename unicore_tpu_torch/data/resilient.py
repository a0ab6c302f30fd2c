"""Fault-tolerant input pipeline (counterpart of
``unicore_tpu/data/resilient.py``): the skip -> retry -> escalate
discipline of the anomaly guard, down in the data layer.

- :class:`~.indexed_dataset.DataIntegrityError` — the typed error every
  dataset raises on a torn, truncated or undecodable record, guard or no
  guard (the port's one definition, in ``indexed_dataset.py``).
- :class:`GuardedDataset` (``--data-guard``) — wraps the top of the
  dataset stack: a transient ``OSError`` retries with bounded backoff; an
  irrecoverably corrupt sample is replaced by a seeded resample from the
  same epoch (:func:`resample_index`, a pure function of (seed, epoch,
  index, attempt) over integers, so workers, processes and resumed runs
  decide alike and batch shapes never change); a corrupt-rate budget
  warns at half and aborts past it.
- :class:`SkipLog` — every skip decision, deduplicated by (epoch, index)
  so a replayed batch after a resume logs once; it rides ``extra_state``
  through checkpoints via the epoch iterator's ``state_dict``, in the
  JAX package's layout (``train_iterator/data_guard``).

Thread workers and inline loading share the main process's dataset and
commit skips straight into the canonical log; a forked worker process
holds a copy whose log is detached (``worker_init``), buffers its
decisions, and relays them with each batch (``drain_health`` in the
worker, ``commit_health`` in the main process, where the budget is
enforced).
"""

import logging
import os
import threading
import time

import numpy as np

from .base_wrapper_dataset import BaseWrapperDataset
from .indexed_dataset import DataIntegrityError

logger = logging.getLogger(__name__)

# domain tag for the resample stream: numpy_seed hashes the (seed, *addl)
# tuple, and python string hashes are salted per process — every addl
# seed here MUST be an integer or determinism dies across resume
_RESAMPLE_TAG = 0xDA7A

# the budget rate is meaningless over a handful of fetches (the first
# sample being corrupt is a 100% rate); the ladder's abort rung only
# engages past this many fetches, warn/skip always apply
_BUDGET_MIN_FETCHES = 64


def resample_index(seed, epoch, index, attempt, n):
    """The seeded replacement draw for a corrupt sample — a pure function
    of (seed, epoch, index, attempt), so every process, worker, and
    resumed run that meets the same corrupt record makes the identical
    decision.  Public because the chaos harness's skip-oracle replays
    it host-side to predict the run's skip log.

    Deliberately a LOCAL generator, not the ``numpy_seed`` global-state
    idiom: dataset ``__getitem__`` runs on concurrent worker threads,
    and save/seed/restore of the process-global RNG state races across
    them — a local RandomState keyed the same way (an integer-tuple
    hash; ints hash unsalted) is immune."""
    mix = int(hash((int(seed), _RESAMPLE_TAG, int(epoch), int(index),
                    int(attempt))) % (2 ** 32))
    return int(np.random.RandomState(mix).randint(n))


class DataGuardConfig:
    """Knobs of the input-pipeline guard (``options.py``'s fault-tolerance
    group; without ``--data-guard`` a corrupt record raises)."""

    def __init__(self, enabled=False, retries=2, backoff=0.05,
                 corrupt_budget=0.01, resample_attempts=8):
        self.enabled = bool(enabled)
        self.retries = max(0, int(retries))
        self.backoff = float(backoff)
        self.corrupt_budget = float(corrupt_budget)
        self.resample_attempts = max(1, int(resample_attempts))

    @classmethod
    def from_args(cls, args):
        return cls(
            enabled=bool(getattr(args, "data_guard", False)),
            retries=getattr(args, "data_retries", 2),
            backoff=getattr(args, "data_retry_backoff", 0.05),
            corrupt_budget=getattr(args, "data_corrupt_budget", 0.01),
            resample_attempts=getattr(args, "data_resample_attempts", 8),
        )


class SkipLog:
    """Canonical, main-process record of every corrupt-sample skip.

    Entries are dicts ``{"epoch", "index", "replacement", "attempt",
    "reason"}`` deduplicated by (epoch, index): the resample is a pure
    function of that pair, so a replayed batch after a SIGKILL+resume
    re-derives the identical decision and must not double-count it.
    ``state_dict``/``load_state_dict`` ride ``extra_state`` through
    checkpoints (via ``EpochBatchIterator``), which is what keeps the
    budget arithmetic — and the chaos harness's oracle comparison —
    exact across resumes."""

    def __init__(self):
        self._lock = threading.Lock()
        self.entries = []
        self._seen = set()
        self.fetches = 0
        self.retries = 0

    def __len__(self):
        return len(self.entries)

    def record(self, entry):
        """Add one skip decision; returns True when it was new (not a
        post-resume replay of an already-logged (epoch, index))."""
        key = (int(entry["epoch"]), int(entry["index"]))
        with self._lock:
            if key in self._seen:
                return False
            self._seen.add(key)
            self.entries.append(dict(entry))
            return True

    def count_fetches(self, n=1, retries=0):
        with self._lock:
            self.fetches += int(n)
            self.retries += int(retries)

    def corrupt_rate(self):
        with self._lock:
            return len(self.entries) / max(self.fetches, 1)

    def counters(self):
        with self._lock:
            return {
                "skipped": len(self.entries),
                "retries": self.retries,
                "fetches": self.fetches,
                "corrupt_rate": len(self.entries) / max(self.fetches, 1),
            }

    def state_dict(self):
        with self._lock:
            return {
                "entries": [dict(e) for e in self.entries],
                "fetches": self.fetches,
                "retries": self.retries,
            }

    def load_state_dict(self, state):
        with self._lock:
            self.entries = [dict(e) for e in state.get("entries", [])]
            self._seen = {
                (int(e["epoch"]), int(e["index"])) for e in self.entries
            }
            self.fetches = int(state.get("fetches", 0))
            self.retries = int(state.get("retries", 0))


class GuardedDataset(BaseWrapperDataset):
    """Guarded fetch wrapper over the TOP of a dataset stack.

    ``__getitem__``: transient ``OSError`` retries with bounded
    exponential backoff; a :class:`DataIntegrityError` (from any layer
    below — the wrapped stack propagates the leaf stores' typed errors)
    triggers the deterministic seeded resample; the corrupt-rate budget
    escalates skip -> warn -> abort.  See the module docstring for the
    worker-relay protocol."""

    def __init__(self, dataset, cfg, seed, skip_log=None):
        super().__init__(dataset)
        self.cfg = cfg
        self.seed = int(seed)
        self.skip_log = skip_log if skip_log is not None else SkipLog()
        self.epoch = 1
        self._pending = []  # worker-process relay buffer (skip entries)
        self._pending_fetches = 0
        self._pending_retries = 0
        self._warned_epochs = set()
        self._lock = threading.Lock()
        # the chaos tool's hang (``--data hang``): the N-th fetch wedges,
        # so the watchdog's dump must name the stuck index and the worker
        # impl; unset, this is a dead compare
        self._hang_at = int(
            os.environ.get("UNICORE_TPU_CHAOS_DATA_HANG", 0) or 0
        )
        self._fetch_no = 0

    # -- pickling (process workers) ------------------------------------

    def __getstate__(self):
        state = self.__dict__.copy()
        # the canonical log stays in the main process; a forked worker
        # buffers into _pending and relays with each batch
        state["skip_log"] = None
        state["_lock"] = None
        state["_pending"] = []
        state["_pending_fetches"] = 0
        state["_pending_retries"] = 0
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def worker_init(self):
        """Called inside a data-worker PROCESS (fork context inherits a
        memory copy, so ``__getstate__`` never ran): detach the
        canonical log so this copy's decisions buffer in ``_pending``
        and relay to the main process with each batch."""
        self.skip_log = None
        self._pending = []
        self._pending_fetches = 0
        self._pending_retries = 0
        self._lock = threading.Lock()

    # -- epoch plumbing -------------------------------------------------

    def set_epoch(self, epoch):
        self.epoch = int(epoch)
        super().set_epoch(epoch)

    # -- the guarded fetch ---------------------------------------------

    def __getitem__(self, index):
        self._maybe_hang()
        self._count(1, 0)
        try:
            return self._fetch(int(index))
        except DataIntegrityError as err:
            return self._resample(int(index), err)

    def _fetch(self, index):
        """One read with transient-IO retry (the ``read_verified``
        discipline: bounded exponential backoff, then escalate as an
        integrity failure).  Retries count into the health counters as
        they happen, so the raised (persistent-failure) path — exactly
        the case the ``data_retries`` metric exists to surface — loses
        none of them."""
        last = None
        for attempt in range(self.cfg.retries + 1):
            try:
                return self.dataset[index]
            except DataIntegrityError:
                raise  # irrecoverable: a torn record does not heal
            except OSError as e:
                last = e
                self._count(0, 1)
                if attempt < self.cfg.retries:
                    logger.warning(
                        "data guard: transient IO error reading sample %d "
                        "(attempt %d/%d): %s", index, attempt + 1,
                        self.cfg.retries, e,
                    )
                    time.sleep(self.cfg.backoff * (2 ** attempt))
        raise DataIntegrityError(
            f"persistent IO failure reading sample {index} after "
            f"{self.cfg.retries + 1} attempts (--data-retries): {last}"
        ) from last

    def _resample(self, index, err):
        """Deterministic skip: replace the corrupt sample with a seeded
        draw from the same epoch stream (batch shapes stay static), or
        raise when the ladder says abort / the skip rung is not opted
        into."""
        if not self.cfg.enabled:
            raise err
        n = len(self.dataset)
        for attempt in range(1, self.cfg.resample_attempts + 1):
            j = resample_index(self.seed, self.epoch, index, attempt, n)
            try:
                # replacement draws deliberately do NOT count as fetches
                # (the budget rate's denominator is REQUESTED samples);
                # their transient retries still count inside _fetch
                sample = self._fetch(j)
            except DataIntegrityError:
                continue  # drew another corrupt record; next attempt
            self._record({
                "epoch": self.epoch, "index": index, "replacement": j,
                "attempt": attempt,
                "reason": f"{type(err).__name__}: {err}"[:200],
            })
            return sample
        raise DataIntegrityError(
            f"sample {index} is corrupt and {self.cfg.resample_attempts} "
            f"seeded resamples all drew corrupt records too "
            f"(--data-resample-attempts) — the dataset is too damaged to "
            f"skip around"
        ) from err

    # -- skip/health bookkeeping ---------------------------------------

    def _count(self, fetches, retries):
        if self.skip_log is not None:
            self.skip_log.count_fetches(fetches, retries)
        else:
            with self._lock:
                self._pending_fetches += fetches
                self._pending_retries += retries

    def _record(self, entry):
        logger.warning(
            "data guard: resampled corrupt sample %d -> %d "
            "(epoch %d, attempt %d): %s", entry["index"],
            entry["replacement"], entry["epoch"], entry["attempt"],
            entry["reason"],
        )
        if self.skip_log is not None:
            if self.skip_log.record(entry):
                self._check_budget()
        else:
            with self._lock:
                self._pending.append(entry)

    def drain_health(self):
        """Worker-process side of the relay: pending skip entries +
        fetch/retry counts since the last batch, cleared."""
        with self._lock:
            out = {
                "skips": self._pending,
                "fetches": self._pending_fetches,
                "retries": self._pending_retries,
            }
            self._pending = []
            self._pending_fetches = 0
            self._pending_retries = 0
        return out if (out["skips"] or out["fetches"] or out["retries"]) \
            else None

    def commit_health(self, health):
        """Main-process side of the relay: fold one worker batch's
        decisions into the canonical log and enforce the budget HERE —
        a worker process cannot see the global rate."""
        if not health or self.skip_log is None:
            return
        self.skip_log.count_fetches(
            health.get("fetches", 0), health.get("retries", 0)
        )
        fresh = False
        for entry in health.get("skips", ()):
            fresh |= self.skip_log.record(entry)
        if fresh:
            self._check_budget()

    def data_counters(self):
        """Counter snapshot for the train loop's ``data_skipped`` /
        ``data_retries`` / ``data_corrupt_rate`` metrics."""
        if self.skip_log is None:
            return None
        return self.skip_log.counters()

    def _check_budget(self):
        """The ladder above plain skips: warn at half the budget, abort
        past it (mirroring skip -> backoff/rewind -> abort for
        anomalies).  Rate = unique skips / samples fetched."""
        c = self.skip_log.counters()
        rate, budget = c["corrupt_rate"], self.cfg.corrupt_budget
        if budget <= 0 or c["fetches"] < _BUDGET_MIN_FETCHES:
            return
        if rate > budget:
            raise DataIntegrityError(
                f"corrupt-sample rate {rate:.4f} ({c['skipped']} skips / "
                f"{c['fetches']} fetches) exceeds --data-corrupt-budget "
                f"{budget} — the dataset (or the storage under it) is "
                f"failing faster than skipping can responsibly hide"
            )
        if rate > budget / 2 and self.epoch not in self._warned_epochs:
            self._warned_epochs.add(self.epoch)
            logger.warning(
                "data guard: corrupt-sample rate %.4f is past half the "
                "--data-corrupt-budget %.4f (%d skips / %d fetches) — "
                "check the dataset files before the abort rung fires",
                rate, budget, c["skipped"], c["fetches"],
            )

    # -- chaos hang injection ------------------------------------------

    def _maybe_hang(self):
        if not self._hang_at:
            return
        with self._lock:
            self._fetch_no += 1
            hit = self._fetch_no == self._hang_at
        if hit:
            logger.warning(
                "CHAOS: wedging data fetch #%d for the watchdog to catch",
                self._hang_at,
            )
            time.sleep(3600.0)


def maybe_guard(dataset, args, seed, cache=None):
    """Wrap ``dataset`` in a :class:`GuardedDataset` when ``--data-guard``
    is on.  ``cache`` (a dict the task owns) keeps ONE wrapper per
    underlying dataset object so the skip log and budget arithmetic
    survive the per-epoch ``get_batch_iterator`` rebuilds."""
    cfg = DataGuardConfig.from_args(args)
    if not cfg.enabled:
        return dataset
    if isinstance(dataset, GuardedDataset):
        return dataset
    key = id(dataset)
    if cache is not None and key in cache:
        return cache[key]
    guard = GuardedDataset(dataset, cfg, seed)
    if cache is not None:
        cache[key] = guard
    return guard
