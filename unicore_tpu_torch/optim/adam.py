"""AdamW (counterpart of ``unicore_tpu/optim/adam.py``): decoupled weight
decay and the JAX package's update —

    m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
    p -= lr sqrt(bc2) / bc1 * m / (sqrt(v) + eps sqrt(bc2)) + lr wd p

With fp32 moments (the default) it runs as multi-tensor
(``torch._foreach_*``) ops over every parameter at once, in place.
``--optim-bf16-moments`` stores m and v in bf16: the update math still
runs in fp32 (the moments upcast on entry, the step uses the fp32 m and
v), and the new moments re-quantize by stochastic rounding
under a distinct seed per (leaf, moment), drawn from the generator the
trainer passes to :meth:`UnicoreAdam.step` — m and v of every leaf in
one multi-tensor rounding call
(:func:`~unicore_tpu_torch.ops.rounding.fp32_to_bf16_sr_multi`).
``--optim-bf16-moments-rounding nearest`` rounds to nearest instead
(:func:`~unicore_tpu_torch.optim.fp16_optimizer.cast_moments`).
Its state is the JAX package's ``opt_state``, ``{"step", "exp_avg",
"exp_avg_sq"}`` (:meth:`UnicoreOptimizer.state_dict`), so the
checkpoints of both packages carry the same moments.
"""

import ast
import math

import torch

from ..ops.prng import draw_seeds
from ..ops.rounding import fp32_to_bf16_sr_multi
from . import register_optimizer
from .fp16_optimizer import cast_moments
from .unicore_optimizer import UnicoreOptimizer


@register_optimizer("adam")
class UnicoreAdam(UnicoreOptimizer):
    state_keys = ("exp_avg", "exp_avg_sq")

    def __init__(self, args, params):
        super().__init__(args, params)
        betas = getattr(args, "adam_betas", "(0.9, 0.999)")
        if isinstance(betas, str):
            betas = ast.literal_eval(betas)
        self.beta1, self.beta2 = float(betas[0]), float(betas[1])
        self.eps = float(getattr(args, "adam_eps", 1e-8))
        self.weight_decay = float(getattr(args, "weight_decay", 0.0))
        self.moments_dtype = (torch.bfloat16
                              if getattr(args, "optim_bf16_moments", False)
                              else torch.float32)
        self.moments_rounding = str(
            getattr(args, "optim_bf16_moments_rounding", None) or "sr")
        self.exp_avg = self._zeros(self.moments_dtype)
        self.exp_avg_sq = self._zeros(self.moments_dtype)

    @classmethod
    def add_args(cls, parser):
        parser.add_argument("--adam-betas", default="(0.9, 0.999)",
                            metavar="B", help="betas for Adam optimizer")
        parser.add_argument("--adam-eps", type=float, default=1e-8,
                            metavar="D", help="epsilon for Adam optimizer")
        parser.add_argument("--weight-decay", "--wd", default=0.0,
                            type=float, metavar="WD", help="weight decay")

    @property
    def wants_update_rng(self):
        return (self.moments_dtype != torch.float32
                and self.moments_rounding == "sr")

    @torch.no_grad()
    def step(self, generator=None):
        b1, b2, lr, wd = self.beta1, self.beta2, self._lr, self.weight_decay
        self.step_count += 1
        bc1 = 1.0 - b1 ** self.step_count
        bc2 = 1.0 - b2 ** self.step_count
        grads = [p.grad.float() for p in self.params]
        store = self.moments_dtype != torch.float32
        # math in fp32 whatever the store type
        m = [x.float() for x in self.exp_avg] if store else self.exp_avg
        v = [x.float() for x in self.exp_avg_sq] if store else self.exp_avg_sq
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, grads, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps * math.sqrt(bc2))
        if wd != 0.0:
            torch._foreach_mul_(self.params, 1.0 - lr * wd)
        torch._foreach_addcdiv_(self.params, m, denom,
                                value=-lr * math.sqrt(bc2) / bc1)
        if store:
            self._store_moments(m, v, generator)

    def _store_moments(self, m, v, generator):
        """Round the fp32 moments ``m``, ``v`` into the bf16 stores: under
        stochastic rounding, seed ``[i, j]`` for leaf i's m (j = 0) and v
        (j = 1), every leaf in one call."""
        if self.moments_rounding != "sr":
            for new, old in zip(m + v, self.exp_avg + self.exp_avg_sq):
                cast_moments(new, self.moments_dtype,
                             rounding=self.moments_rounding, out=old)
            return
        if generator is None:
            raise ValueError("bf16 moments with stochastic rounding "
                             "need a generator for their seeds")
        seeds = draw_seeds(generator, (len(self.params), 2))
        fp32_to_bf16_sr_multi(
            [t for pair in zip(m, v) for t in pair], seeds,
            [t for pair in zip(self.exp_avg, self.exp_avg_sq) for t in pair])
