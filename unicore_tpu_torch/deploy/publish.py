"""Live weight publish: the train -> serve bridge (counterpart of
``unicore_tpu/deploy/publish.py``; the manifest and ``.sum`` formats are
the JAX package's, so a manifest either package publishes is read by
the other).

A manifest is a small versioned record (monotonic publish id,
checkpoint path, sha256 set, source step) written into a watched
publish directory with the same atomic marker-last protocol as the
checkpoints themselves (:func:`~unicore_tpu_torch.checkpoint_utils.
atomic_save`), so a manifest is absent, in flight (data landed, ``.sum``
not yet), verified, or provably TORN — never silently garbage.  The
serve side (:class:`~unicore_tpu_torch.deploy.subscriber.
DeploySubscriber`) polls the directory at the fleet router's step
boundary and only surfaces verified manifests.

:class:`WeightPublisher` runs after a checkpoint's final copies land
(``--publish-dir``): it re-reads the file through
:func:`~unicore_tpu_torch.checkpoint_utils.read_verified` — a publish
never points at bytes that were not re-hashed end to end — and records
the sidecar digest in the manifest, so the serve-side loader can detect
a checkpoint replaced after its manifest landed.
"""

import logging
import os
import pickle
import re
from dataclasses import dataclass, field

from ..checkpoint_utils import (CheckpointIntegrityError, atomic_save,
                                file_integrity, read_sidecar, read_verified)

logger = logging.getLogger(__name__)


class DeployError(RuntimeError):
    """Typed deployment failure (bad manifest contents, sharded or
    structurally unusable checkpoint, digest drift) — the deploy
    analogue of ``CheckpointIntegrityError``, so rollout code can
    catch deployment faults without a broad except."""


MANIFEST_RE = re.compile(r"^manifest-(\d{8})\.pt$")


def manifest_name(publish_id):
    return f"manifest-{int(publish_id):08d}.pt"


@dataclass
class Manifest:
    """One published weight version.  ``sha256`` maps checkpoint
    basenames to the hex digests recorded at publish time (from the
    checkpoint's own ``.sum`` sidecar, post-``read_verified``)."""

    publish_id: int
    checkpoint: str
    sha256: dict
    source_step: int = 0
    path: str = field(default=None, compare=False)


def read_manifest(path):
    """Verified manifest read: bytes come through ``read_verified``
    (sha256 vs the ``.sum`` marker, retry/backoff), then unpickle into
    a :class:`Manifest`.  Torn or structurally invalid manifests raise
    :class:`~unicore_tpu_torch.checkpoint_utils.CheckpointIntegrityError` /
    :class:`DeployError` — callers decide quarantine, never silence."""
    payload = read_verified(path)
    try:
        obj = pickle.loads(payload)
    except Exception as e:
        raise CheckpointIntegrityError(
            f"manifest {path} verified but does not unpickle: {e}"
        ) from e
    try:
        return Manifest(
            publish_id=int(obj["publish_id"]),
            checkpoint=str(obj["checkpoint"]),
            sha256=dict(obj["sha256"]),
            source_step=int(obj.get("source_step", 0)),
            path=path,
        )
    except (KeyError, TypeError, ValueError) as e:
        raise DeployError(
            f"manifest {path} is missing required fields: {e!r}"
        ) from e


def scan_publish_dir(publish_dir):
    """Deterministic directory scan: ``{publish_id: (path, state)}``
    for every ``manifest-*.pt``, where state is
    :func:`~unicore_tpu_torch.checkpoint_utils.file_integrity`'s verdict —
    ``"ok"`` (verified), ``"unverified"`` (data landed, marker not
    yet: an in-flight publish, poll again), or ``"torn"`` (bytes
    contradict the marker: permanent, quarantine material)."""
    out = {}
    try:
        names = sorted(os.listdir(publish_dir))
    except FileNotFoundError:
        return out
    for fn in names:
        m = MANIFEST_RE.match(fn)
        if not m:
            continue
        path = os.path.join(publish_dir, fn)
        out[int(m.group(1))] = (path, file_integrity(path))
    return out


class WeightPublisher:
    """Writes one manifest per finalized checkpoint into
    ``publish_dir``.  Ids are monotonic across process restarts — the
    next id is recovered from the directory itself, so two sequential
    training runs publishing into the same directory never collide."""

    def __init__(self, publish_dir):
        self.publish_dir = publish_dir
        os.makedirs(publish_dir, exist_ok=True)
        self.published = 0

    def next_publish_id(self):
        seen = scan_publish_dir(self.publish_dir)
        return (max(seen) + 1) if seen else 1

    def publish(self, checkpoint_path, *, source_step=0):
        """Verify ``checkpoint_path`` end to end and land a manifest
        for it.  Raises ``CheckpointIntegrityError`` when the
        checkpoint is torn/unverified — a publish must never point the
        fleet at bytes that did not re-hash clean."""
        read_verified(checkpoint_path)  # full sha256 re-read, or raise
        side = read_sidecar(checkpoint_path)
        publish_id = self.next_publish_id()
        path = os.path.join(self.publish_dir, manifest_name(publish_id))
        atomic_save(
            {
                "publish_id": publish_id,
                "checkpoint": os.path.abspath(checkpoint_path),
                "sha256": {
                    os.path.basename(checkpoint_path): side["digest"],
                },
                "source_step": int(source_step),
            },
            path,
        )
        self.published += 1
        logger.info(
            "published manifest %s (checkpoint %s @ step %d)",
            path, checkpoint_path, source_step,
        )
        return read_manifest(path)
