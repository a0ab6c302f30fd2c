"""Graceful preemption: SIGTERM/SIGINT -> drain-and-exit.

A copy of ``GracefulShutdown`` from ``unicore_tpu/resilience/
preemption.py`` (the port imports nothing of the JAX package).  The
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
