"""Triangular cyclical LR (CLR, arxiv 1506.01186): thin shim over
``schedules.triangular`` (the JAX package's
``triangular_lr_scheduler.py``: ``--max-lr`` required, a half period of
``--lr-period-updates // 2``, the same checks and errors)."""

import functools

from . import register_lr_scheduler
from .schedules import triangular
from .unicore_lr_scheduler import FunctionalLRScheduler


@register_lr_scheduler("triangular")
class TriangularLRSchedule(FunctionalLRScheduler):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument('--max-lr', required=True, type=float, metavar='LR',
                            help='max learning rate, must be more than args.lr')
        parser.add_argument('--lr-period-updates', default=5000, type=float, metavar='LR',
                            help='initial number of updates per period (cycle length)')
        parser.add_argument('--lr-shrink', default=0.1, type=float, metavar='LS',
                            help='shrink factor for annealing')
        parser.add_argument('--shrink-min', action='store_true',
                            help='if set, also shrinks min lr')

    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        if len(args.lr) > 1:
            raise ValueError(
                "Cannot use a fixed learning rate schedule with triangular;"
                " consider --lr-scheduler=fixed instead."
            )
        if args.max_lr <= args.lr[0]:
            raise ValueError("max_lr must be more than lr")
        self.lr = args.lr[0]
        self._schedule = functools.partial(
            triangular, min_lr=args.lr[0], max_lr=args.max_lr,
            stepsize=args.lr_period_updates // 2, shrink=args.lr_shrink,
            shrink_min=args.shrink_min,
        )
        self.optimizer.set_lr(self.lr)
