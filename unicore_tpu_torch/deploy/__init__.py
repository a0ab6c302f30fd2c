"""Train-to-serve continuous deployment (counterpart of
``unicore_tpu/deploy``): :class:`~unicore_tpu_torch.deploy.publish.
WeightPublisher` lands verified, versioned manifests into a watched
directory as training checkpoints finalize;
:class:`~unicore_tpu_torch.deploy.subscriber.DeploySubscriber` surfaces
them at the fleet router's step boundary;
:class:`~unicore_tpu_torch.deploy.rollout.RolloutController` walks them
through a canary-gated, zero-downtime hot-swap rollout (promote or
rollback)."""

from .loader import (load_manifest_params, load_serve_model,
                     load_serve_params)
from .publish import (DeployError, Manifest, WeightPublisher,
                      manifest_name, read_manifest, scan_publish_dir)
from .rollout import RolloutController
from .subscriber import DeploySubscriber

__all__ = [
    "DeployError", "Manifest", "WeightPublisher", "manifest_name",
    "read_manifest", "scan_publish_dir", "DeploySubscriber",
    "RolloutController", "load_manifest_params", "load_serve_model",
    "load_serve_params",
]
