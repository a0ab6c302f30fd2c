"""Consistent-hash ring: session/user keys -> replica ids (a copy of
``unicore_tpu/fleet/ring.py``; the port imports nothing of the JAX
package, and both rings map every key alike).

The router's affinity layer.  Properties the fleet tier is built on:

- **Stability.**  The hash is a keyed-nothing blake2b over bytes —
  NEVER Python's salted ``hash()`` — so the same key maps to the same
  replica across processes, restarts, and hosts.  Affinity that only
  holds within one process is not affinity.
- **Balance.**  Each replica owns ``vnodes`` points on the ring
  (default 64), which bounds the load skew of the arc lengths; with 64
  vnodes the busiest replica stays within a small constant factor of
  the mean over realistic key populations.
- **Minimal remap.**  Removing a replica moves ONLY the keys that
  replica owned (they fall to the next point clockwise); every other
  key's mapping is untouched.  Adding it back restores the original
  mapping exactly.  This is the property that makes a future
  shared-prefix KV cache survive membership churn: a replica's warm
  sessions stay warm through everyone else's restarts.

The ring is pure host logic over sorted ints — no tensors, no clocks — so
every property is directly testable.
"""

import bisect
import hashlib


def stable_hash(data):
    """64-bit stable digest of ``data`` (str or bytes)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "big"
    )


class HashRing:
    """Consistent-hash ring over replica ids with virtual nodes."""

    def __init__(self, replica_ids=(), vnodes=64):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.vnodes = int(vnodes)
        self._points = []   # sorted [(point, replica_id)]
        self._members = set()
        for rid in replica_ids:
            self.add(rid)

    def __len__(self):
        return len(self._members)

    def __contains__(self, rid):
        return rid in self._members

    def members(self):
        return sorted(self._members)

    def _vnode_points(self, rid):
        return [stable_hash(f"{rid}#{v}") for v in range(self.vnodes)]

    def add(self, rid):
        """Join a replica; only keys on its new arcs remap to it."""
        if rid in self._members:
            raise ValueError(f"replica {rid!r} already on the ring")
        self._members.add(rid)
        for p in self._vnode_points(rid):
            bisect.insort(self._points, (p, rid))

    def remove(self, rid):
        """Leave the ring; only the departing replica's keys remap."""
        if rid not in self._members:
            raise KeyError(f"replica {rid!r} not on the ring")
        self._members.discard(rid)
        self._points = [(p, r) for (p, r) in self._points if r != rid]

    def discard(self, rid):
        """Idempotent :meth:`remove` — the failover path (a replica can
        die mid-rolling-restart, AFTER the restart already took it off
        the ring; eviction must not raise over a no-op).  Returns True
        when the replica was a member.  This is the leave-WITHOUT-drain
        entry: the remap properties are identical to a planned
        ``remove`` — only the dead replica's keys move."""
        if rid not in self._members:
            return False
        self.remove(rid)
        return True

    def lookup(self, key):
        """The replica owning ``key`` (first point clockwise)."""
        if not self._points:
            raise LookupError("ring is empty (no replicas joined)")
        h = stable_hash(key)
        i = bisect.bisect_right(self._points, (h, chr(0x10FFFF)))
        if i == len(self._points):
            i = 0  # wrap: the lowest point owns the top arc
        return self._points[i][1]
