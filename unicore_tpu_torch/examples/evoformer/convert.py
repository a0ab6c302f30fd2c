"""Carry the JAX package's Evoformer weights into the port.

Uni-Core ships no torch Evoformer, so there are no reference torch names
to keep: the port names its submodules after the flax modules, and
:func:`state_dict_from_flax` maps the flax tree one to one — ``blocks_{i}``
to ``blocks.{i}``, a ``Dense`` kernel transposed into ``weight``, a
LayerNorm ``scale`` into ``weight``.  It takes the tree of the whole
``EvoformerModel`` or of any one of its modules.
"""

from ..lm.convert import apply_rules


def _t(kernel):
    return kernel.T


_RULES = [
    (r"blocks_(\d+)/(.+)/kernel", "blocks.{0}.{1}.weight", _t),
    (r"blocks_(\d+)/(.+)/scale", "blocks.{0}.{1}.weight", None),
    (r"blocks_(\d+)/(.+)/bias", "blocks.{0}.{1}.bias", None),
    (r"(.+)/kernel", "{0}.weight", _t),
    (r"(.+)/scale", "{0}.weight", None),
    (r"(.+)/bias", "{0}.bias", None),
]


def state_dict_from_flax(params):
    """Flax Evoformer params -> the port's ``state_dict`` (float32 CPU
    tensors).  Raises on a parameter no rule maps."""
    return apply_rules(params, _RULES)
