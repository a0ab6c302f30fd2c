"""Adadelta (counterpart of ``unicore_tpu/optim/adadelta.py``): the JAX
update in multi-tensor ops over every parameter.

    g' = g + wd p;  sq = rho sq + (1 - rho) g' g'
    delta = sqrt(acc + eps) / sqrt(sq + eps) g'
    acc = rho acc + (1 - rho) delta delta;  p = p - lr delta

XLA contracts ``g + wd p``, the two running averages (``rho x`` plus the
rounded ``((1 - rho) y) y``) and ``p - lr delta`` into fused
multiply-adds, and so does this step (``add(alpha=)``).  One op is not
the JAX one: XLA rewrites ``a / sqrt(b)`` into ``a * rsqrt(b)``, and its
rsqrt on the CPU is an approximation, where this step divides by the
correctly rounded square root.  ``delta`` can thus differ by an fp32 ulp
or two, and ``acc`` and the params inherit that; every other op rounds
as the JAX step does.  Its state is the JAX ``opt_state``, ``{"step",
"square_avg", "acc_delta"}``.
"""

import torch

from . import register_optimizer
from .unicore_optimizer import UnicoreOptimizer, foreach_sqrt


@register_optimizer("adadelta")
class Adadelta(UnicoreOptimizer):
    state_keys = ("square_avg", "acc_delta")

    def __init__(self, args, params):
        super().__init__(args, params)
        self.rho = float(getattr(args, "adadelta_rho", 0.9))
        self.eps = float(getattr(args, "adadelta_eps", 1e-6))
        self.weight_decay = float(getattr(args, "weight_decay", 0.0))
        self.square_avg = self._zeros()
        self.acc_delta = self._zeros()

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--adadelta-rho", type=float, default=0.9,
                            metavar="RHO", help="coefficient used for "
                            "computing a running average")
        parser.add_argument("--adadelta-eps", type=float, default=1e-6,
                            metavar="EPS",
                            help="term added to the denominator")
        parser.add_argument("--weight-decay", "--wd", default=0.0,
                            type=float, metavar="WD", help="weight decay")

    def _average(self, avg, x):
        """``rho avg + ((1 - rho) x) x``, the sum in one rounding."""
        term = torch._foreach_mul(x, 1 - self.rho)
        torch._foreach_mul_(term, x)
        return torch._foreach_add(term, avg, alpha=self.rho)

    @torch.no_grad()
    def step(self):
        self.step_count += 1
        grads = [p.grad.float() for p in self.params]
        if self.weight_decay != 0.0:
            grads = torch._foreach_add(grads, self.params,
                                       alpha=self.weight_decay)
        self.square_avg = self._average(self.square_avg, grads)
        delta = foreach_sqrt(torch._foreach_add(self.acc_delta, self.eps))
        denom = foreach_sqrt(torch._foreach_add(self.square_avg, self.eps))
        torch._foreach_div_(delta, denom)
        torch._foreach_mul_(delta, grads)
        self.acc_delta = self._average(self.acc_delta, delta)
        torch._foreach_add_(self.params, delta, alpha=-self._lr)
