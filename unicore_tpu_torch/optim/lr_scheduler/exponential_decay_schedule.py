"""Exponential-decay LR: thin shim over ``schedules.exponential_decay``
(the JAX package's ``exponential_decay_schedule.py``: the same flags,
defaults and initial warmup lr, ``--stair-decay`` included)."""

import functools

from . import register_lr_scheduler
from .schedules import exponential_decay
from .unicore_lr_scheduler import FunctionalLRScheduler


@register_lr_scheduler("exponential_decay")
class ExponentialDecayLRSchedule(FunctionalLRScheduler):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument('--warmup-updates', default=1000, type=int, metavar='N',
                            help='warmup the learning rate linearly for the first N updates')
        parser.add_argument('--decay-ratio', default=0.95, type=float)
        parser.add_argument('--decay-steps', default=500, type=int)
        parser.add_argument('--stair-decay', action="store_true")

    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        self.lr = args.lr[0]
        self._schedule = functools.partial(
            exponential_decay, base_lr=args.lr[0],
            decay_ratio=args.decay_ratio, decay_steps=args.decay_steps,
            warmup_updates=args.warmup_updates,
            stair=getattr(args, "stair_decay", False),
        )
        init = 1.0 / args.warmup_updates if args.warmup_updates > 0 else 1.0
        self.optimizer.set_lr(init * self.lr)
