"""Polynomial-decay LR: thin shim over ``schedules.polynomial_decay``
(behavioral parity with the reference's ``polynomial_decay_schedule.py``,
including ``--warmup-ratio`` driven by the trainer's total_train_steps).
Epoch-level behavior — per-epoch ``--lr`` lists and ``--force-anneal`` —
lives here; the per-update curve is the pure function."""

import functools

from . import register_lr_scheduler
from .schedules import polynomial_decay
from .unicore_lr_scheduler import FunctionalLRScheduler


@register_lr_scheduler("polynomial_decay")
class PolynomialDecayLRSchedule(FunctionalLRScheduler):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument('--force-anneal', '--fa', type=int, metavar='N',
                            help='force annealing at specified epoch')
        parser.add_argument('--warmup-updates', default=0, type=int, metavar='N',
                            help='warmup the learning rate linearly for the first N updates')
        parser.add_argument('--warmup-ratio', default=-1.0, type=float, metavar='N',
                            help='warmup the learning rate linearly for the first N-percent updates')
        parser.add_argument('--end-learning-rate', default=0.0, type=float)
        parser.add_argument('--power', default=1.0, type=float)
        parser.add_argument('--total-num-update', default=1000000, type=int)

    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        if args.warmup_ratio > 0:
            assert total_train_steps is not None, (
                "--warmup-ratio requires the trainer to provide total_train_steps"
            )
            self.warmup_updates = int(args.warmup_ratio * total_train_steps)
            self.total_num_update = total_train_steps
        else:
            assert args.total_num_update > 0
            self.warmup_updates = args.warmup_updates
            self.total_num_update = args.total_num_update
        self._rebind(args.lr[0])
        init = 1.0 / self.warmup_updates if self.warmup_updates > 0 else 1.0
        self.optimizer.set_lr(init * self.lr)

    def _rebind(self, base_lr):
        self.lr = base_lr
        self._schedule = functools.partial(
            polynomial_decay, base_lr=base_lr,
            end_lr=self.args.end_learning_rate, power=self.args.power,
            warmup_updates=self.warmup_updates,
            total_updates=self.total_num_update,
        )

    def step_begin_epoch(self, epoch):
        # per-epoch base LR list; after --force-anneal the base freezes at
        # whatever the optimizer currently runs
        lrs = self.args.lr
        fa = self.args.force_anneal
        if fa is None or epoch < fa:
            self._rebind(lrs[min(epoch, len(lrs) - 1)])
        # warmup factor the previous update count earned (corrected by the
        # next step_update)
        w = self.warmup_updates
        warm = min(max(self._last_step, 1) / w, 1.0) if w > 0 else 1.0
        self.optimizer.set_lr(warm * self.lr)
        return self.optimizer.get_lr()
