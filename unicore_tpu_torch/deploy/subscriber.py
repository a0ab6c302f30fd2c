"""Serve-side manifest watcher (counterpart of
``unicore_tpu/deploy/subscriber.py``).

A :class:`DeploySubscriber` is polled at the fleet router's step
boundary (all deploy control flow advances in fleet steps, with an
injectable clock for any wall-time gating) and answers one question
deterministically: is there a newer verified manifest than the last one
it reported?  Newest wins — if three manifests landed since the last
poll, only the highest id is surfaced.

Torn manifests (data bytes contradict their ``.sum`` marker, the
permanent signature of a crashed publish) are never surfaced: they are
recorded once into :attr:`torn` and reported through :meth:`take_torn`
so the rollout controller can quarantine the publish id and trip its
breaker.  An unverified manifest (data landed, marker not yet) is
skipped and re-examined on the next poll.
"""

import logging
import time

from .publish import read_manifest, scan_publish_dir

logger = logging.getLogger(__name__)


class DeploySubscriber:
    """Deterministic publish-directory poller.

    ``min_interval_s`` rate-limits the directory scan on the injectable
    ``clock`` (default ``time.monotonic``); at the default ``0.0``
    every :meth:`poll` scans, which is what trace-replay tests and the
    chaos harness use — virtual-time replays stay deterministic because
    the clock is theirs."""

    def __init__(self, publish_dir, *, start_after=0,
                 min_interval_s=0.0, clock=None):
        self.publish_dir = publish_dir
        self.last_seen = int(start_after)
        self.torn = {}            # publish_id -> path (reported once)
        self._new_torn = []
        self.polls = 0
        self.scans = 0
        self.min_interval_s = float(min_interval_s)
        self._clock = clock or time.monotonic
        self._last_scan_at = None

    def _due(self):
        if self.min_interval_s <= 0.0:
            return True
        now = self._clock()
        if (self._last_scan_at is not None
                and now - self._last_scan_at < self.min_interval_s):
            return False
        self._last_scan_at = now
        return True

    def poll(self):
        """Return the newest verified :class:`~unicore_tpu_torch.deploy.
        publish.Manifest` with ``publish_id > last_seen``, else None.
        Advances ``last_seen`` past everything it surfaces (and past
        superseded intermediates)."""
        self.polls += 1
        if not self._due():
            return None
        self.scans += 1
        seen = scan_publish_dir(self.publish_dir)
        fresh_ok = []
        for pid in sorted(seen):
            if pid <= self.last_seen:
                continue
            path, state = seen[pid]
            if state == "torn":
                if pid not in self.torn:
                    self.torn[pid] = path
                    self._new_torn.append((pid, path))
                    logger.error(
                        "publish %d at %s is TORN (bytes contradict the "
                        ".sum marker); it will never be served", pid, path,
                    )
                continue
            if state != "ok":
                continue  # in-flight publish: marker not landed yet
            fresh_ok.append(pid)
        if not fresh_ok:
            return None
        pid = max(fresh_ok)
        path = seen[pid][0]
        try:
            manifest = read_manifest(path)
        except Exception as e:
            # verified a moment ago, unreadable now: treat as torn —
            # the typed read already re-raised through the integrity
            # machinery, this poll just records and moves on
            if pid not in self.torn:
                self.torn[pid] = path
                self._new_torn.append((pid, path))
            logger.error("manifest %s went unreadable: %s", path, e)
            return None
        self.last_seen = pid
        return manifest

    def take_torn(self):
        """Drain newly-discovered torn publishes as ``[(publish_id,
        path), ...]`` — each is reported exactly once."""
        out, self._new_torn = self._new_torn, []
        return out

    def describe(self):
        return {
            "publish_dir": self.publish_dir,
            "last_seen": self.last_seen,
            "torn": sorted(self.torn),
            "polls": self.polls,
            "scans": self.scans,
        }
