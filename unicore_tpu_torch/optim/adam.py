"""AdamW (counterpart of ``unicore_tpu/optim/adam.py``): decoupled weight
decay, fp32 moments, the JAX package's update bit of arithmetic for bit
of arithmetic —

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    p -= lr sqrt(bc2) / bc1 * m / (sqrt(v) + eps sqrt(bc2)) + lr wd p

— run as multi-tensor (``torch._foreach_*``) ops over every parameter at
once, in place.  ``--optim-bf16-moments`` is not ported (ROADMAP.md B4).
"""

import ast
import math

import torch

from . import register_optimizer
from .unicore_optimizer import UnicoreOptimizer


@register_optimizer("adam")
class UnicoreAdam(UnicoreOptimizer):
    def __init__(self, args, params):
        super().__init__(args, params)
        betas = getattr(args, "adam_betas", "(0.9, 0.999)")
        if isinstance(betas, str):
            betas = ast.literal_eval(betas)
        self.beta1, self.beta2 = float(betas[0]), float(betas[1])
        self.eps = float(getattr(args, "adam_eps", 1e-8))
        self.weight_decay = float(getattr(args, "weight_decay", 0.0))
        self.step_count = 0
        self.exp_avg = [torch.zeros_like(p, dtype=torch.float32)
                        for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p, dtype=torch.float32)
                           for p in self.params]

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--adam-betas", default="(0.9, 0.999)",
                            metavar="B", help="betas for Adam optimizer")
        parser.add_argument("--adam-eps", type=float, default=1e-8,
                            metavar="D", help="epsilon for Adam optimizer")
        parser.add_argument("--weight-decay", "--wd", default=0.0,
                            type=float, metavar="WD", help="weight decay")

    @torch.no_grad()
    def step(self):
        b1, b2, lr, wd = self.beta1, self.beta2, self._lr, self.weight_decay
        self.step_count += 1
        bc1 = 1.0 - b1 ** self.step_count
        bc2 = 1.0 - b2 ** self.step_count
        grads = [p.grad.float() for p in self.params]
        torch._foreach_mul_(self.exp_avg, b1)
        torch._foreach_add_(self.exp_avg, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.exp_avg_sq, b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, value=1.0 - b2)
        denom = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_add_(denom, self.eps * math.sqrt(bc2))
        if wd != 0.0:
            torch._foreach_mul_(self.params, 1.0 - lr * wd)
        torch._foreach_addcdiv_(self.params, self.exp_avg, denom,
                                value=-lr * math.sqrt(bc2) / bc1)
