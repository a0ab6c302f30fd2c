"""Model base class of the port: a ``torch.nn.Module`` with the
registry's ``add_args``/``build_model`` classmethods (the reference's
``BaseUnicoreModel``; the JAX package's is a flax module)."""

from torch import nn


class BaseUnicoreModel(nn.Module):
    @classmethod
    def add_args(cls, parser):
        """Add model-specific arguments to the parser."""

    @classmethod
    def build_model(cls, args, task):
        """Build a new model instance from config + task."""
        raise NotImplementedError("Model must implement build_model")
