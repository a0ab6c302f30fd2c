"""Fixed (epoch-listed) LR: per-update linear warmup via
``schedules.fixed_warmup``; the epoch machinery — ``--lr`` lists and
``--force-anneal`` shrink — is host state here (behavioral parity with the
reference's ``fixed_schedule.py``)."""

import functools

from . import register_lr_scheduler
from .schedules import fixed_warmup
from .unicore_lr_scheduler import FunctionalLRScheduler


@register_lr_scheduler("fixed")
class FixedLRSchedule(FunctionalLRScheduler):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument('--force-anneal', '--fa', type=int, metavar='N',
                            help='force annealing at specified epoch')
        parser.add_argument('--lr-shrink', default=0.1, type=float, metavar='LS',
                            help='shrink factor for annealing, lr_new = (lr * lr_shrink)')
        parser.add_argument('--warmup-updates', default=0, type=int, metavar='N',
                            help='warmup the learning rate linearly for the first N updates')

    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        self._rebind(args.lr[0])

    def _rebind(self, base_lr):
        self.lr = self.base_lr = base_lr
        self._schedule = functools.partial(
            fixed_warmup, base_lr=base_lr,
            warmup_updates=self.args.warmup_updates,
        )

    def state_dict(self):
        # the epoch's base lr: ``self.lr`` is the warmed one during warmup,
        # and rebinding to it would shrink every later update's lr
        return {"lr": self.base_lr}

    def load_state_dict(self, state_dict):
        if "lr" in state_dict:
            self._rebind(state_dict["lr"])

    def _epoch_lr(self, epoch):
        lrs, fa = self.args.lr, self.args.force_anneal
        if fa is None or epoch < fa:
            return lrs[min(epoch - 1, len(lrs) - 1)]
        return lrs[-1] * self.args.lr_shrink ** (epoch + 1 - fa)

    def step_begin_epoch(self, epoch):
        self._rebind(self._epoch_lr(epoch))
        # apply the warmup factor the *previous* update count earned (the
        # epoch hook runs between updates; the next step_update corrects)
        w = self.args.warmup_updates
        warm = min((self._last_step + 1) / w, 1.0) if w > 0 else 1.0
        self.optimizer.set_lr(warm * self.lr)
        return self.optimizer.get_lr()
