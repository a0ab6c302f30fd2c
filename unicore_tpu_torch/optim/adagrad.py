"""Adagrad (counterpart of ``unicore_tpu/optim/adagrad.py``): the JAX
update with its roundings, in multi-tensor ops over every parameter.

    g' = g + wd p;  s = s + g' g';  p = p + (-lr g') / (sqrt(s) + eps)

XLA contracts ``g + wd p`` and ``s + g' g'`` into fused multiply-adds
(``add(alpha=)`` and ``addcmul`` here); the quotient rounds, then the
sum, as in the JAX step.  eps is torch's Adagrad default, 1e-10.  Its
state is the JAX ``opt_state``, ``{"step", "sum"}``.
"""

import torch

from . import register_optimizer
from .unicore_optimizer import UnicoreOptimizer, foreach_sqrt


@register_optimizer("adagrad")
class Adagrad(UnicoreOptimizer):
    state_keys = ("sum",)

    def __init__(self, args, params):
        super().__init__(args, params)
        self.weight_decay = float(getattr(args, "weight_decay", 0.0))
        self.eps = 1e-10  # torch Adagrad default
        self.sum = self._zeros()

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--weight-decay", "--wd", default=0.0,
                            type=float, metavar="WD", help="weight decay")

    @torch.no_grad()
    def step(self):
        self.step_count += 1
        grads = [p.grad.float() for p in self.params]
        if self.weight_decay != 0.0:
            grads = torch._foreach_add(grads, self.params,
                                       alpha=self.weight_decay)
        torch._foreach_addcmul_(self.sum, grads, grads)
        denom = foreach_sqrt(self.sum)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_mul(grads, -self._lr)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(self.params, update)
