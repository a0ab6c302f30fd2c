"""Cyclical cosine LR with warmup (SGDR, arxiv 1608.03983): thin shim
over ``schedules.cosine`` (the JAX package's ``cosine_lr_scheduler.py``:
the same flags, defaults, checks and errors; the period is
``--max-update`` less the warmup when ``--lr-period-updates`` is unset)."""

import functools

from . import register_lr_scheduler
from .schedules import cosine
from .unicore_lr_scheduler import FunctionalLRScheduler


@register_lr_scheduler("cosine")
class CosineLRSchedule(FunctionalLRScheduler):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument('--warmup-updates', default=0, type=int, metavar='N',
                            help='warmup the learning rate linearly for the first N updates')
        parser.add_argument('--warmup-init-lr', default=-1, type=float, metavar='LR',
                            help='initial learning rate during warmup phase; default is args.lr')
        parser.add_argument('--min-lr', default=0.0, type=float, metavar='LR',
                            help='min learning rate')
        parser.add_argument('--max-lr', type=float, metavar='LR',
                            help='max learning rate, must be more than args.lr')
        parser.add_argument('--t-mult', default=1, type=float, metavar='LR',
                            help='factor to grow the length of each period')
        parser.add_argument('--lr-period-updates', default=-1, type=float, metavar='LR',
                            help='initial number of updates per period')
        parser.add_argument('--lr-shrink', default=0.1, type=float, metavar='LS',
                            help='shrink factor for annealing')

    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        if isinstance(args.lr, (list, tuple)) and len(args.lr) > 1:
            raise ValueError(
                "Cannot use a fixed learning rate schedule with cosine;"
                " consider --lr-scheduler=fixed instead."
            )
        max_lr = args.lr[0] if isinstance(args.lr, (list, tuple)) else args.lr
        if max_lr <= args.min_lr:
            raise ValueError("max_lr must be more than min_lr")
        if args.warmup_init_lr < 0:
            args.warmup_init_lr = args.min_lr
        period = args.lr_period_updates
        if period <= 0:
            assert args.max_update > 0, (
                "Either --max-update or --lr-period-updates must be set"
            )
            period = args.max_update - args.warmup_updates
        self._schedule = functools.partial(
            cosine, max_lr=max_lr, min_lr=args.min_lr, period=period,
            t_mult=args.t_mult, shrink=args.lr_shrink,
            warmup_updates=args.warmup_updates,
            warmup_init_lr=args.warmup_init_lr,
        )
        self.lr = args.warmup_init_lr
        self.optimizer.set_lr(self.lr)
