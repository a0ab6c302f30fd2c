"""Step watchdog: a hung device step must not hang the run forever
(counterpart of ``unicore_tpu/resilience/watchdog.py``).

A wedged kernel or a lost card surfaces as a host sync that never
returns — no Python exception, no log line.  The watchdog is a daemon
thread with a deadline: the trainer and the serve engine arm it around
their one blocking host sync per step and disarm on return.  CUDA
launches are asynchronous, so a hung kernel shows at that sync, not at
its launch; and a kernel builds (``ops/build.py``) inside its first
launch, which stays OUTSIDE the armed window, so a cold run's minutes
of ``nvcc`` never read as a hang.  On expiry the watchdog logs the
caller's context line, dumps every thread's stack (faulthandler) and
runs ``on_timeout`` — by default ``os._exit(87)``: a sync blocked in
the CUDA runtime cannot be unwound from Python, and exiting lets a
supervisor restart from the last checkpoint.  The watcher runs while
the main thread is blocked because torch releases the GIL inside a
device-to-host copy."""

import faulthandler
import logging
import os
import sys
import threading
import time
import weakref

logger = logging.getLogger(__name__)

EXIT_CODE = 87  # distinct from OOM kills / signal deaths for supervisors


def _default_timeout_action(phase, timeout):
    logger.error(
        "watchdog: device step hung for > %.0fs in %s; dumping stacks "
        "and exiting %d so the supervisor can restart from the last "
        "checkpoint", timeout, phase, EXIT_CODE,
    )
    try:
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        sys.stderr.flush()
    except Exception:  # noqa: BLE001 - diagnostics must not block the exit
        pass
    os._exit(EXIT_CODE)


class StepWatchdog:
    """``with watchdog.armed("train_step/dispatch"): <blocking sync>``.

    ``context``: optional no-arg callable whose string is logged when
    the watchdog fires (the trainer names its background checkpoint
    writer's state, the serve engine its queue depths).  A ``timeout``
    of 0 or less disarms it for good: arming is then a no-op and no
    thread ever starts.

    A bound-method ``context`` is held weakly, so the watcher thread
    never keeps its owner (an engine with its KV pool and parameters on
    the card) alive: once the owner is collected the thread ends, as it
    does at :meth:`close`."""

    def __init__(self, timeout, on_timeout=None, context=None):
        self.timeout = float(timeout)
        self.on_timeout = on_timeout or _default_timeout_action
        if hasattr(context, "__self__"):
            self._context = weakref.WeakMethod(context)
        else:
            self._context = lambda: context
        self.fired = False
        self._phase = None
        self._deadline = None
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread = None

    # -- arming --------------------------------------------------------

    class _Armed:
        def __init__(self, dog, phase):
            self.dog = dog
            self.phase = phase

        def __enter__(self):
            self.dog._arm(self.phase)
            return self.dog

        def __exit__(self, *exc):
            self.dog._disarm()
            return False

    def armed(self, phase, detail=None):
        """``detail`` (optional) is appended to the phase string at arm
        time."""
        if detail:
            phase = f"{phase} [{detail}]"
        return self._Armed(self, phase)

    def _arm(self, phase):
        if self.timeout <= 0:
            return
        with self._lock:
            self._phase = phase
            self._deadline = time.monotonic() + self.timeout
        self._ensure_thread()
        self._wake.set()

    def _disarm(self):
        with self._lock:
            self._phase = None
            self._deadline = None

    def status(self):
        """Live arm state for other diagnostics: the fleet router's
        report carries each replica's, so a timeout names which
        replica's sync was armed, for how long, and whether it fired."""
        with self._lock:
            phase, deadline = self._phase, self._deadline
        waited = None
        if deadline is not None:
            waited = round(self.timeout - (deadline - time.monotonic()), 3)
        return {"phase": phase, "waited_s": waited, "fired": self.fired}

    # -- the watcher thread --------------------------------------------

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._watch, name="unicore-step-watchdog", daemon=True
            )
            self._thread.start()

    def _owner_gone(self):
        return isinstance(self._context, weakref.WeakMethod) and \
            self._context() is None

    def _watch(self):
        poll = max(0.05, min(1.0, self.timeout / 4.0))
        while not self._stop and not self._owner_gone():
            with self._lock:
                deadline, phase = self._deadline, self._phase
            if deadline is not None and time.monotonic() > deadline:
                self.fired = True
                self._disarm()
                context = self._context()
                if context is not None:
                    try:
                        logger.error("watchdog context: %s", context())
                    except Exception:  # noqa: BLE001 - best-effort context
                        pass
                    del context  # the idle wait must not hold the owner
                self.on_timeout(phase, self.timeout)
                continue
            if deadline is None:
                self._wake.wait(timeout=5.0)
                self._wake.clear()
            else:
                time.sleep(poll)

    def close(self):
        """Stop the watcher thread and wait for it to end."""
        self._stop = True
        self._wake.set()
        thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout=5.0)
