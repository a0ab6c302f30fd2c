"""Inverse-sqrt LR with warmup: thin shim over ``schedules.inverse_sqrt``
(the JAX package's ``inverse_square_root_schedule.py``: the same flags,
defaults, checks and errors)."""

import functools

from . import register_lr_scheduler
from .schedules import inverse_sqrt
from .unicore_lr_scheduler import FunctionalLRScheduler


@register_lr_scheduler("inverse_sqrt")
class InverseSquareRootSchedule(FunctionalLRScheduler):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument('--warmup-updates', default=4000, type=int, metavar='N',
                            help='warmup the learning rate linearly for the first N updates')
        parser.add_argument('--warmup-init-lr', default=-1, type=float, metavar='LR',
                            help='initial learning rate during warmup phase; default is args.lr')

    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        if isinstance(args.lr, (list, tuple)) and len(args.lr) > 1:
            raise ValueError(
                "Cannot use a fixed learning rate schedule with inverse_sqrt;"
                " consider --lr-scheduler=fixed instead."
            )
        base_lr = args.lr[0] if isinstance(args.lr, (list, tuple)) else args.lr
        if args.warmup_init_lr < 0:
            args.warmup_init_lr = 0 if args.warmup_updates > 0 else base_lr
        self._schedule = functools.partial(
            inverse_sqrt, base_lr=base_lr,
            warmup_updates=args.warmup_updates,
            warmup_init_lr=args.warmup_init_lr,
        )
        self.lr = args.warmup_init_lr
        self.optimizer.set_lr(self.lr)
