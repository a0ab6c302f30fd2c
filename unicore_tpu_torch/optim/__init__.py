"""Optimizer registry of the port, keyed by ``--optimizer``."""

from ..registry import setup_registry
from .unicore_optimizer import UnicoreOptimizer

build_optimizer_, register_optimizer, OPTIMIZER_REGISTRY = setup_registry(
    "--optimizer", base_class=UnicoreOptimizer, default="adam", required=True)


def build_optimizer(args, params):
    return build_optimizer_(args, params)


# each module registers its optimizer under the JAX package's name
from . import adadelta, adagrad, adam, sgd  # noqa: E402,F401
from . import lr_scheduler  # noqa: E402,F401
