"""LR scheduler base class (a copy of the JAX package's
``optim/lr_scheduler/unicore_lr_scheduler.py``): schedulers run on the
host and compute a python float each update, keeping the reference's
stateful contract (``step_begin_epoch`` / ``step(epoch, val_loss)`` /
``step_update(num_updates)``).
"""

from argparse import Namespace


class UnicoreLRScheduler:
    def __init__(self, args: Namespace, optimizer, total_train_steps):
        super().__init__()
        self.args = args
        self.optimizer = optimizer
        self.total_train_steps = total_train_steps
        self.best = None
        self.lr = args.lr[0] if isinstance(args.lr, (list, tuple)) else args.lr

    @classmethod
    def add_args(cls, parser):
        """Add scheduler-specific arguments to the parser."""
        pass

    def set_lr(self, lr):
        self.lr = lr

    def get_lr(self):
        """Current learning rate (python float)."""
        return self.lr

    def state_dict(self):
        return {"best": self.best, "lr": self.lr}

    def load_state_dict(self, state_dict):
        self.best = state_dict.get("best", None)
        if "lr" in state_dict:
            self.lr = state_dict["lr"]

    def step_begin_epoch(self, epoch):
        """Update the lr at the beginning of a new epoch."""
        pass

    def step(self, epoch, val_loss=None):
        """Update the lr at the end of a given epoch."""
        if val_loss is not None:
            if self.best is None:
                self.best = val_loss
            else:
                self.best = min(self.best, val_loss)

    def step_update(self, num_updates):
        """Update the lr after each optimizer update. Returns the new lr."""
        return self.get_lr()


class FunctionalLRScheduler(UnicoreLRScheduler):
    """Shim binding a pure ``step -> lr`` function (``schedules.py``) to
    the stateful reference scheduler API.  Subclasses set
    ``self._schedule`` to a zero-state callable; everything else —
    epoch hooks, checkpoint state, val-loss tracking — stays on the base
    class.  The same callable can be handed to a jitted step for fully
    on-device LR computation."""

    _schedule = None  # set by subclass __init__: callable(step) -> lr
    _last_step = 0    # highest update count seen (epoch hooks read it)

    def schedule(self, step):
        return self._schedule(step)

    def step_update(self, num_updates):
        self._last_step = num_updates
        self.lr = float(self._schedule(num_updates))
        self.optimizer.set_lr(self.lr)
        return self.lr
