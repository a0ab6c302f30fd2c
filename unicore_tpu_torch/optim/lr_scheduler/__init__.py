"""LR-scheduler registry of the port, keyed by ``--lr-scheduler``."""

from ...registry import setup_registry
from .unicore_lr_scheduler import UnicoreLRScheduler

build_lr_scheduler_, register_lr_scheduler, LR_SCHEDULER_REGISTRY = (
    setup_registry("--lr-scheduler", base_class=UnicoreLRScheduler,
                   default="fixed"))


def build_lr_scheduler(args, optimizer, total_train_steps):
    return build_lr_scheduler_(args, optimizer, total_train_steps)


# each module registers its scheduler under the JAX package's name
from . import (  # noqa: E402,F401
    cosine_lr_scheduler, exponential_decay_schedule, fixed_schedule,
    inverse_square_root_schedule, pass_through, polynomial_decay_schedule,
    reduce_lr_on_plateau, tri_stage_lr_scheduler, triangular_lr_scheduler)
