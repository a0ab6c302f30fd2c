"""Graceful preemption: SIGTERM/SIGINT -> drain-and-exit.

A copy of ``GracefulShutdown`` and ``ChildShutdown`` from
``unicore_tpu/resilience/preemption.py`` (the port imports nothing of
the JAX package).  The
handler only SETS A FLAG — all real work (closing admission, shedding
queued requests, writing the drain report) happens at the next step
boundary on the main thread, because a signal handler must not run in
the middle of a device dispatch.

A second SIGINT restores the default handler and re-raises, so an
operator can still hard-kill a wedged run from the keyboard."""

import logging
import signal
import threading

logger = logging.getLogger(__name__)


class GracefulShutdown:
    """Install on the MAIN thread; poll :attr:`requested` per step."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self.requested = False
        self.signum = None
        self._previous = {}
        self._installed = False

    # -- lifecycle -----------------------------------------------------

    def install(self):
        if threading.current_thread() is not threading.main_thread():
            # signal.signal raises from a worker thread; a resilience
            # helper must not be the thing that kills the run
            logger.warning(
                "GracefulShutdown.install() skipped: not on main thread"
            )
            return self
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._handle)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        for sig, prev in self._previous.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # interpreter shutting down
                pass
        self._previous = {}
        self._installed = False

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False

    # -- programmatic trigger ------------------------------------------

    def request(self, signum=None):
        """Trigger the shutdown flag without a delivered signal, so
        drain behavior is testable without process-level signal
        plumbing.  Same contract as a signal: only
        the flag flips; all real work happens at the caller's next
        step boundary."""
        self.requested = True
        if signum is not None:
            self.signum = signum

    # -- fleet fan-out -------------------------------------------------

    def child(self, name=None):
        """A per-replica drain flag linked to this (fleet-level)
        shutdown: the fleet router wires one child into every
        ServeEngine replica, so ONE SIGTERM to the fleet process drains
        every replica, while a rolling restart requests one child at a
        time and leaves the rest serving."""
        return ChildShutdown(parent=self, name=name)

    # -- handler -------------------------------------------------------

    def _handle(self, signum, frame):
        if self.requested and signum == signal.SIGINT:
            # second Ctrl-C: the operator wants OUT, now
            logger.warning("second SIGINT: restoring default handler")
            self.uninstall()
            raise KeyboardInterrupt
        self.requested = True
        self.signum = signum
        logger.warning(
            "received %s: will drain and exit at the next step "
            "boundary (send SIGINT again to abort immediately)",
            signal.Signals(signum).name,
        )


class ChildShutdown:
    """One replica's drain flag, ORed with an optional parent
    :class:`GracefulShutdown`.

    A replica must drain when EITHER the whole fleet was signalled (the
    parent's SIGTERM/SIGINT handler fired) or the router singled it out
    (rolling restart calls :meth:`request` with ``signal.SIGTERM`` —
    the same flag path a delivered signal flips, so the engine's drain
    machinery cannot tell the difference).  :meth:`clear` re-opens the
    replica after its restart; a fleet-wide parent request is NOT
    clearable from a child — a draining fleet stays draining.

    :meth:`mark_lost` is the FAILOVER terminal state: the router marks
    a dead replica's child lost when it evicts it without a drain.  A
    lost child's flag is permanent — ``clear()`` no longer re-opens it
    — so a wedged engine that later "wakes up" finds its drain flag set
    and sheds instead of serving stale ring traffic; the replacement
    replica always gets a FRESH child.

    :meth:`mark_retired` is the SCALE-DOWN terminal state: the
    autoscaler retires a replica through the zero-drop drain, and once
    the drain completes the slot is gone for good — the same permanent
    flag as ``lost``, another label, so the report can tell a planned
    retirement from a crash eviction."""

    def __init__(self, parent=None, name=None):
        self.parent = parent
        self.name = name
        self._requested = False
        self._signum = None
        self.lost = False
        self.retired = False

    @property
    def requested(self):
        return self._requested or bool(
            self.parent is not None and self.parent.requested
        )

    @property
    def signum(self):
        if self._signum is not None:
            return self._signum
        return None if self.parent is None else self.parent.signum

    def request(self, signum=None):
        """Single this replica out for drain (rolling restart)."""
        self._requested = True
        if signum is not None:
            self._signum = signum

    def mark_lost(self):
        """Permanently drain this child: the replica it guards was
        evicted WITHOUT a drain (crash/wedge failover).  The flag can
        never be cleared again — a zombie replica must shed, not
        serve."""
        self.lost = True
        self._requested = True

    def mark_retired(self):
        """Permanently drain this child: the replica it guards was
        RETIRED by a scale-down.  Like :meth:`mark_lost`, the flag can
        never be cleared — a retired engine that is somehow stepped
        again must shed, not serve — but the label tells the operator
        this was a planned, zero-drop exit."""
        self.retired = True
        self._requested = True

    def clear(self):
        """Reset the CHILD's own flag (post-restart re-open).  The
        parent's fleet-wide request, if any, still reads through; a LOST
        or RETIRED child stays drained forever (neither eviction nor
        retirement is a restart — a comeback gets a fresh child)."""
        if self.lost or self.retired:
            logger.warning(
                "ChildShutdown.clear() on %s replica %r ignored — an "
                "evicted/retired replica cannot re-open its own drain "
                "flag", "lost" if self.lost else "retired", self.name,
            )
            return
        self._requested = False
        self._signum = None
