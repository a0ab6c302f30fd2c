"""Last-good snapshot ring: host copies of the training state for the
escalation ladder's rewind (counterpart of
``unicore_tpu/resilience/snapshot.py``).

A snapshot is a tree (dicts and lists) whose tensor leaves are CPU
copies of the trainer's live tensors: the master parameters, the
optimizer's state, the EMA, the loss scaler and the guard.  Under ZeRO-1
each rank copies the slices it holds and nothing is gathered — the JAX
ring's "addressable shards, no global assembly" rule — so every rank
rewinds its own slices in lockstep.  :func:`restore_state` writes a
snapshot back into the live tensors in place (``copy_``), so whatever
holds references to them (the optimizer, the module) sees the restored
values."""

import collections

import torch


def snapshot_state(state):
    """Host copy of ``state`` (dicts, lists and tuples of tensors; other
    leaves are kept as they are)."""
    if isinstance(state, dict):
        return {k: snapshot_state(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return [snapshot_state(v) for v in state]
    if torch.is_tensor(state):
        return state.detach().to("cpu", copy=True)
    return state


@torch.no_grad()
def restore_state(live, snap):
    """Copy ``snap`` (a :func:`snapshot_state` capture of a tree shaped
    like ``live``) into ``live``'s tensors in place."""
    if isinstance(live, dict):
        for k in live:
            restore_state(live[k], snap[k])
    elif isinstance(live, (list, tuple)):
        if len(live) != len(snap):
            raise ValueError(f"snapshot holds {len(snap)} leaves for "
                             f"{len(live)}")
        for a, b in zip(live, snap):
            restore_state(a, b)
    elif torch.is_tensor(live):
        live.copy_(snap)


class SnapshotRing:
    """Bounded ring of ``(num_updates, dispatch_count, snapshot)``."""

    def __init__(self, size=2):
        self.size = max(1, int(size))
        self._ring = collections.deque(maxlen=self.size)

    def __len__(self):
        return len(self._ring)

    def take(self, state, num_updates, dispatch_count):
        self._ring.append(
            (int(num_updates), int(dispatch_count), snapshot_state(state)))

    def latest(self):
        """The newest entry or None; not consumed (repeated rewinds to
        one last-good state are legitimate: the abort rung bounds them)."""
        return self._ring[-1] if self._ring else None

    def clear(self):
        self._ring.clear()
