"""Optimizer base class of the port (counterpart of
``unicore_tpu/optim/unicore_optimizer.py``): it owns a list of fp32
master parameters, keeps the host-side learning rate the scheduler sets,
and applies one update in place from the parameters' ``.grad``.
Gradient normalization, clipping and the skip of a non-finite update
live in the trainer."""


class UnicoreOptimizer:
    def __init__(self, args, params):
        self.args = args
        self.params = [p for p in params if p.requires_grad]
        lr = getattr(args, "lr", 0.0)
        self._lr = float(lr[0]) if isinstance(lr, (list, tuple)) else float(lr)

    @classmethod
    def add_args(cls, parser):
        """Add optimizer-specific arguments to the parser."""

    @classmethod
    def build_optimizer(cls, args, params):
        return cls(args, params)

    def get_lr(self):
        return self._lr

    def set_lr(self, lr):
        self._lr = float(lr)

    def step(self):
        """One update of ``self.params`` from their ``.grad``."""
        raise NotImplementedError

    def state_dict(self):
        """The optimizer's state in the JAX package's ``opt_state``
        shape."""
        raise NotImplementedError

    def load_state_dict(self, state_dict):
        raise NotImplementedError
