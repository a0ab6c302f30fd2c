"""Carry the Evoformer's weights between the JAX package and the port.

Uni-Core ships no torch Evoformer, so there are no reference torch names
to keep: the port names its submodules after the flax modules, and
:func:`state_dict_from_flax` maps the flax tree one to one — ``blocks_{i}``
to ``blocks.{i}``, a ``Dense`` kernel transposed into ``weight``, a
LayerNorm ``scale`` into ``weight``.  It takes the tree of the whole
``EvoformerModel`` or of any one of its modules.  :func:`flax_from_state_dict`
goes the other way: a 2-D ``weight`` is a Dense kernel, a 1-D one a
LayerNorm scale (the model has no other weights).
"""

from ..lm.convert import apply_inverse_rules, apply_rules, linear_kernel


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


_INVERSE_RULES = [
    # (port name regex, flax path template, transform(value, heads))
    (r"blocks\.(\d+)\.(.+)\.kernel", "blocks_{0}/{1}/kernel", linear_kernel),
    (r"blocks\.(\d+)\.(.+)\.(scale|bias)", "blocks_{0}/{1}/{2}", None),
    (r"(.+)\.kernel", "{0}/kernel", linear_kernel),
    (r"(.+)\.(scale|bias)", "{0}/{1}", None),
]


def flax_from_state_dict(state_dict, heads=None):
    """The port's ``state_dict`` -> the flax Evoformer tree (numpy
    arrays).  Raises on a tensor no rule maps."""
    named = {}
    for name, value in state_dict.items():
        stem, _, leaf = name.rpartition(".")
        if leaf == "weight":
            leaf = "kernel" if value.ndim == 2 else "scale"
        named[f"{stem}.{leaf}"] = value
    return apply_inverse_rules(named, _INVERSE_RULES, heads)


def state_dict_from_flax(params):
    """Flax Evoformer params -> the port's ``state_dict`` (float32 CPU
    tensors).  Raises on a parameter no rule maps."""
    return apply_rules(params, _RULES)
