"""Model base class of the port: a ``torch.nn.Module`` with the
registry's ``add_args``/``build_model`` classmethods (the reference's
``BaseUnicoreModel``; the JAX package's is a flax module).

A model whose JAX counterpart exists names its plugin's converter
module in ``flax_convert`` (``state_dict_from_flax`` and
``flax_from_state_dict``) and, where the layout needs it, its head
count in ``flax_heads``: the weights then carry over between the two
packages (:meth:`load_flax_params`), and the checkpoints of either
package hold the same tree (:meth:`flax_tree`, :meth:`named_from_flax`).
"""

from torch import nn


class BaseUnicoreModel(nn.Module):
    flax_convert = None
    flax_heads = None

    @classmethod
    def add_args(cls, parser):
        """Add model-specific arguments to the parser."""

    @classmethod
    def build_model(cls, args, task):
        """Build a new model instance from config + task."""
        raise NotImplementedError("Model must implement build_model")

    def _converter(self):
        if self.flax_convert is None:
            raise NotImplementedError(
                f"{type(self).__name__} has no JAX-package layout "
                "(flax_convert)")
        return self.flax_convert

    def flax_tree(self, named):
        """``named`` (parameter name -> tensor or array: this model's
        parameters, or an optimizer moment of each) as the JAX package's
        flax tree of numpy copies."""
        return self._converter().flax_from_state_dict(named, self.flax_heads)

    def flax_items(self, named):
        """``(name, flax path, value)`` of each entry of ``named``: the
        path a tuple of the flax tree's keys, the value in the flax layout
        (for a tensor, a view of it, so its strides say where each flax
        element lies in the port's tensor)."""
        return self._converter().flax_items(named, self.flax_heads)

    def named_from_flax(self, tree):
        """A flax tree of this model's layout -> parameter name -> float32
        tensor."""
        return self._converter().state_dict_from_flax(tree)

    def load_flax_params(self, params):
        """Load the JAX package's flax params into this model: both
        packages then hold the same weights."""
        self.load_state_dict(self.named_from_flax(params), strict=True)
