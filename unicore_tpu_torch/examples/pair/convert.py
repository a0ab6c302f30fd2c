"""Carry the pair model's weights between the JAX package and the port.

Its flax tree (``embed``, ``blocks_{i}``, ``final_norm``, ``head``) is a
subset of the Evoformer's layout, so the Evoformer's rules map it one to
one both ways.
"""

from ..evoformer.convert import (flax_from_state_dict, flax_items,  # noqa: F401
                                 state_dict_from_flax)
