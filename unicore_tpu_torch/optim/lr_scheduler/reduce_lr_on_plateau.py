"""Reduce-LR-on-plateau schedule (a copy of the JAX package's
``reduce_lr_on_plateau.py``): linear warmup per update, then at each
epoch's end the valid loss the train loop passes to ``lr_step``; after
more than ``--lr-patience`` epochs without a better one (torch's
ReduceLROnPlateau 'rel' threshold, ``--maximize-best-checkpoint-metric``
for a metric that grows) the lr shrinks by ``--lr-shrink``.  Its state,
``{best, last_epoch, num_bad_epochs, lr, warmup_end}``, rides the
checkpoint."""

from . import register_lr_scheduler
from .unicore_lr_scheduler import UnicoreLRScheduler


@register_lr_scheduler("reduce_lr_on_plateau")
class ReduceLROnPlateauLRSchedule(UnicoreLRScheduler):
    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        if len(args.lr) > 1:
            raise ValueError(
                "Cannot use a fixed learning rate schedule with"
                " reduce_lr_on_plateau; consider --lr-scheduler=fixed instead."
            )
        self.factor = args.lr_shrink
        self.threshold = args.lr_threshold
        self.patience = args.lr_patience
        self.mode = (
            "max" if getattr(args, "maximize_best_checkpoint_metric", False) else "min"
        )
        self.plateau_best = None
        self.num_bad_epochs = 0
        self.last_epoch = 0

        warmup_end_lr = args.lr[0]
        if args.warmup_init_lr < 0:
            args.warmup_init_lr = 0 if args.warmup_updates > 0 else warmup_end_lr
        if args.warmup_updates > 0:
            self.lr_step = (warmup_end_lr - args.warmup_init_lr) / args.warmup_updates
        self.warmup_end = True if args.warmup_updates <= 0 else False
        self.warmup_end_lr = warmup_end_lr
        self.lr = args.warmup_init_lr
        self.optimizer.set_lr(self.lr)

    @classmethod
    def add_args(cls, parser):
        parser.add_argument('--lr-shrink', default=0.1, type=float, metavar='LS',
                            help='shrink factor for annealing, lr_new = (lr * lr_shrink)')
        parser.add_argument('--lr-threshold', default=1e-4, type=float, metavar='LT',
                            help='threshold for measuring the new optimum')
        parser.add_argument('--lr-patience', default=0, type=int,
                            help='number of epochs with no improvement before reducing lr')
        parser.add_argument('--warmup-updates', default=0, type=int, metavar='N',
                            help='warmup the learning rate linearly for the first N updates')
        parser.add_argument('--warmup-init-lr', default=-1, type=float, metavar='LR',
                            help='initial learning rate during warmup phase; default is args.lr')

    def state_dict(self):
        return {
            "best": self.plateau_best,
            "last_epoch": self.last_epoch,
            "num_bad_epochs": self.num_bad_epochs,
            "lr": self.lr,
            "warmup_end": self.warmup_end,
        }

    def load_state_dict(self, state_dict):
        self.plateau_best = state_dict.get("best")
        self.last_epoch = state_dict.get("last_epoch", 0)
        self.num_bad_epochs = state_dict.get("num_bad_epochs", 0)
        if "lr" in state_dict:
            self.lr = state_dict["lr"]
            self.optimizer.set_lr(self.lr)
        self.warmup_end = state_dict.get("warmup_end", self.warmup_end)

    def _is_better(self, metric):
        if self.plateau_best is None:
            return True
        if self.mode == "min":
            return metric < self.plateau_best * (1.0 - self.threshold)
        return metric > self.plateau_best * (1.0 + self.threshold)

    def step(self, epoch, val_loss=None):
        if val_loss is not None and self.warmup_end:
            if self._is_better(val_loss):
                self.plateau_best = val_loss
                self.num_bad_epochs = 0
            else:
                self.num_bad_epochs += 1
                if self.num_bad_epochs > self.patience:
                    self.lr = self.optimizer.get_lr() * self.factor
                    self.optimizer.set_lr(self.lr)
                    self.num_bad_epochs = 0
        else:
            self.last_epoch = epoch
        return self.optimizer.get_lr()

    def step_update(self, num_updates):
        if self.args.warmup_updates > 0:
            if num_updates <= self.args.warmup_updates:
                self.lr = self.args.warmup_init_lr + num_updates * self.lr_step
                self.optimizer.set_lr(self.lr)
            else:
                if self.warmup_end is False:
                    self.warmup_end = True
        return self.optimizer.get_lr()
