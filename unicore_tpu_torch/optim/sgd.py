"""SGD with momentum (counterpart of ``unicore_tpu/optim/sgd.py``): the
JAX update with its roundings, in multi-tensor ops over every parameter.

    g' = g + wd p;  buf = mom buf + g';  p = p - lr buf

XLA contracts each of the three lines into one fused multiply-add, so
each is one ``add(alpha=)`` here, which is one too.  Without momentum
there is no buffer and ``p = p - lr g'``.  Its state is the JAX
``opt_state``: ``{"step"}``, with ``"momentum_buffer"`` only when the
momentum is not 0.
"""

import torch

from . import register_optimizer
from .unicore_optimizer import UnicoreOptimizer


@register_optimizer("sgd")
class SGD(UnicoreOptimizer):
    def __init__(self, args, params):
        super().__init__(args, params)
        self.momentum = float(getattr(args, "momentum", 0.0))
        self.weight_decay = float(getattr(args, "weight_decay", 0.0))
        if self.momentum != 0.0:
            self.state_keys = ("momentum_buffer",)
            self.momentum_buffer = self._zeros()

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--momentum", default=0.0, type=float,
                            metavar="M", help="momentum factor")
        parser.add_argument("--weight-decay", "--wd", default=0.0,
                            type=float, metavar="WD", help="weight decay")

    @torch.no_grad()
    def step(self):
        self.step_count += 1
        grads = [p.grad.float() for p in self.params]
        if self.weight_decay != 0.0:
            # torch SGD's L2 term, folded into the gradient
            grads = torch._foreach_add(grads, self.params,
                                       alpha=self.weight_decay)
        if self.momentum != 0.0:
            self.momentum_buffer = grads = torch._foreach_add(
                grads, self.momentum_buffer, alpha=self.momentum)
        torch._foreach_add_(self.params, grads, alpha=-self._lr)
