"""Loss registry of the port, keyed by ``--loss``."""

from ..registry import setup_registry
from .unicore_loss import UnicoreLoss

build_loss_, register_loss, LOSS_REGISTRY = setup_registry(
    "--loss", base_class=UnicoreLoss, default="masked_lm")


def build_loss(args, task):
    return build_loss_(args, task)


from . import cross_entropy, masked_lm  # noqa: E402,F401  (registers them)
