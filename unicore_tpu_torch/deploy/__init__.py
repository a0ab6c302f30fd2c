"""Checkpoint -> serve model (counterpart of the loader of
``unicore_tpu/deploy``; publishing, subscribers and rollouts are not
ported: ROADMAP.md A12)."""

from .loader import DeployError, load_serve_model, load_serve_params  # noqa
