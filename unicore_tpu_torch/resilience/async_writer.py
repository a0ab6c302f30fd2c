"""Background checkpoint writer: saves stream to disk off the step path
(copy-and-adapt of ``unicore_tpu/resilience/async_writer.py``, which has
no framework in it, without the capture ownership its rewind checks:
the port's snapshots are copies of their own, so the rewind waits on
:meth:`in_flight` alone).

The synchronous part of a save is only the device->host capture.
Pickling, sha256 hashing, the final-dir copies and retention run here,
on ONE daemon worker thread, while training continues.  The class keeps
three rules:

1. **No swallowed IO.**  A failed background write is recorded and
   re-raised on the main thread at the next step boundary (:meth:`poll`)
   as :class:`CheckpointWriteError`: the run never believes a save
   landed that never hit the disk.
2. **Bounded queue.**  ``submit`` blocks once ``max_queue`` saves are in
   flight (the wait is counted): a disk slower than the save interval
   stalls the step path instead of filling host memory with captures.
3. **Drain on shutdown.**  :meth:`drain` blocks until every submitted job
   has landed (FIFO), so the end of a run can prove its final checkpoint
   is on disk; failures found while draining still raise through
   :meth:`poll`.
"""

import collections
import logging
import threading
import time

logger = logging.getLogger(__name__)


class CheckpointWriteError(RuntimeError):
    """A background checkpoint write failed after retries.  Raised on the
    main thread at the next step boundary (or while draining), so the
    failure is attributable and the supervisor restarts from the last
    checkpoint that actually landed."""


class _Job:
    __slots__ = ("label", "fn", "done")

    def __init__(self, label, fn):
        self.label = label
        self.fn = fn
        self.done = threading.Event()


class AsyncCheckpointWriter:
    """One background thread draining a bounded FIFO of save jobs."""

    def __init__(self, max_queue=2):
        self.max_queue = max(1, int(max_queue))
        self._jobs = collections.deque()
        self._lock = threading.Lock()
        self._slot_free = threading.Condition(self._lock)
        self._job_ready = threading.Condition(self._lock)
        self._failures = []
        self._active = None
        self._active_since = None
        self._closed = False
        self._thread = None

    # -- submission ----------------------------------------------------

    def submit(self, fn, *, label="checkpoint"):
        """Queue ``fn`` (a no-argument callable doing the write).  Blocks
        while ``max_queue`` jobs are already pending or active."""
        job = _Job(label, fn)
        t0 = time.perf_counter()
        with self._lock:
            if self._closed:
                raise RuntimeError("AsyncCheckpointWriter is closed")
            waited = False
            while self._pending_locked() >= self.max_queue:
                waited = True
                self._slot_free.wait(timeout=1.0)
                if self._closed:
                    raise RuntimeError("AsyncCheckpointWriter is closed")
            self._jobs.append(job)
            if waited:
                logger.warning(
                    "checkpoint writer backpressure: waited %.2fs for a "
                    "queue slot (disk slower than the save interval?)",
                    time.perf_counter() - t0)
            self._job_ready.notify()
        self._ensure_thread()

    def _pending_locked(self):
        return len(self._jobs) + (1 if self._active is not None else 0)

    # -- worker --------------------------------------------------------

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._work, name="unicore-ckpt-writer", daemon=True)
            self._thread.start()

    def _work(self):
        while True:
            with self._lock:
                while not self._jobs:
                    if self._closed:
                        return
                    self._job_ready.wait(timeout=1.0)
                job = self._jobs.popleft()
                self._active = job
                self._active_since = time.monotonic()
            try:
                job.fn()
            except BaseException as e:  # surfaced via poll(), never lost
                logger.error("background checkpoint write %r FAILED: %s",
                             job.label, e, exc_info=True)
                with self._lock:
                    self._failures.append((job.label, e))
            finally:
                with self._lock:
                    self._active = None
                    self._slot_free.notify_all()
                job.done.set()

    # -- main-thread surface -------------------------------------------

    def poll(self):
        """Raise the oldest background failure not yet raised (if any);
        later failures surface on later polls."""
        with self._lock:
            if not self._failures:
                return
            label, err = self._failures.pop(0)
        raise CheckpointWriteError(
            f"background checkpoint write {label!r} failed: {err}") from err

    def status(self):
        """One-line writer state for the watchdog's timeout dump: a slow
        background writer (harmless to the device) reads apart from a
        hung device step."""
        with self._lock:
            if self._active is not None:
                busy = time.monotonic() - (self._active_since or 0)
                return (
                    f"background checkpoint writer: WRITING "
                    f"{self._active.label!r} for {busy:.1f}s "
                    f"({len(self._jobs)} queued) — a slow writer does not "
                    f"block device dispatch; this timeout is about the "
                    f"device step itself"
                )
            queued = len(self._jobs)
        if queued:
            return f"background checkpoint writer: {queued} job(s) queued"
        return "background checkpoint writer: idle"

    def in_flight(self):
        """True while a save is being written or waits in the queue."""
        with self._lock:
            return self._active is not None or bool(self._jobs)

    def drain(self):
        """Block until every submitted job has finished (FIFO order).
        Does not raise on recorded failures: call :meth:`poll` after."""
        while True:
            with self._lock:
                job = self._active or (self._jobs[0] if self._jobs else None)
            if job is None:
                return
            job.done.wait()

    def close(self):
        """Stop the worker after every queued save has landed."""
        self.drain()
        with self._lock:
            self._closed = True
            self._job_ready.notify_all()
            self._slot_free.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=5.0)
