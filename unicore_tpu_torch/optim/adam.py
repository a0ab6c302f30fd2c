"""AdamW (counterpart of ``unicore_tpu/optim/adam.py``): decoupled weight
decay and the JAX package's update, rounded where the jitted JAX update
rounds —

    m = fma(b1, m, (1 - b1) g);  v = fma(b2, v, (1 - b2) (g g))
    delta = (-ss m) / (sqrt(v) + eps sqrt(bc2));  delta = fma(-lr wd, p, delta)
    p = p + delta

``bc1 = 1 - b1**step``, ``bc2 = 1 - b2**step``, ``sqrt(bc2)``, the step
size ``ss = lr sqrt(bc2) / bc1`` and ``eps sqrt(bc2)`` are fp32, as JAX
forms them from its fp32 step count and lr (:func:`bias_corrections`),
computed on the host from the host's update count: the same values on
the card and the CPU, and no device sync.  XLA contracts each
``a x + b y`` of the moments by rounding the ``(1 - b) y`` product and
fusing ``b x`` (``add(alpha=)`` here, one rounding; from bf16 stores the
other way round, see :meth:`UnicoreAdam.step`), and the weight-decay
term into the quotient (one more ``add(alpha=)``).

With fp32 moments (the default) it runs as multi-tensor
(``torch._foreach_*``) ops over every parameter at once.
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

import torch

from ..ops.prng import draw_seeds
from ..ops.rounding import fp32_to_bf16_sr_multi
from . import register_optimizer
from .fp16_optimizer import cast_moments
from .unicore_optimizer import UnicoreOptimizer, foreach_sqrt


def bias_corrections(b1, b2, eps, lr, step):
    """``(bc1, bc2, step_size, eps_term)`` of update ``step`` as the jitted
    JAX update forms them: fp32 arithmetic on an fp32 step count and lr,
    the betas and eps taken to fp32 (weakly typed there), the root
    correctly rounded.  Python floats holding those fp32 values."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    stepf = f32(float(step))
    bc1 = 1.0 - f32(b1) ** stepf
    bc2 = 1.0 - f32(b2) ** stepf
    root = foreach_sqrt([bc2])[0]
    step_size = f32(lr) * root / bc1
    return (bc1.item(), bc2.item(), step_size.item(),
            (f32(eps) * root).item())


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
        b1, b2, wd = self.beta1, self.beta2, self.weight_decay
        self.step_count += 1
        _, _, step_size, eps_term = bias_corrections(
            b1, b2, self.eps, self._lr, self.step_count)
        grads = [p.grad.float() for p in self.params]
        # math in fp32 whatever the store type; 1 - b is the Python float
        # that JAX takes to fp32.  Each list is dropped as soon as nothing
        # reads it: with fp32 moments the step holds two fp32 copies of
        # the parameters beyond them (the root and the update) at most.
        if self.moments_dtype == torch.float32:
            # fma(b1, m, round((1 - b1) g)), fma(b2, v, round((1 - b2)
            # round(g g))), formed in new lists that replace the old
            # moments at once
            m = torch._foreach_mul(grads, 1.0 - b1)
            torch._foreach_add_(m, self.exp_avg, alpha=b1)
            self.exp_avg = m
            v = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(v, 1.0 - b2)
            torch._foreach_add_(v, self.exp_avg_sq, alpha=b2)
            self.exp_avg_sq = v
            v_kept = None
        else:
            # from bf16 stores XLA fuses the other products: m and the v
            # it stores are fma(1 - b1, g, round(b1 m)) and
            # fma(1 - b2, g^2, round(b2 v)), while the v under the root is
            # the fp32 path's
            gg = torch._foreach_mul(grads, grads)
            m = [x.float() for x in self.exp_avg]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1.0 - b1)
            v_old = [x.float() for x in self.exp_avg_sq]
            v_kept = list(torch._foreach_mul(v_old, b2))
            torch._foreach_add_(v_kept, gg, alpha=1.0 - b2)
            torch._foreach_mul_(gg, 1.0 - b2)
            torch._foreach_add_(gg, v_old, alpha=b2)
            v, gg, v_old = gg, None, None
        denom = foreach_sqrt(v)
        v = None
        torch._foreach_add_(denom, eps_term)
        delta = torch._foreach_mul(m, -step_size)
        torch._foreach_div_(delta, denom)
        denom = None
        if wd != 0.0:
            decay = (torch.tensor(self._lr, dtype=torch.float32)
                     * torch.tensor(wd, dtype=torch.float32)).item()
            torch._foreach_add_(delta, self.params, alpha=-decay)
        torch._foreach_add_(self.params, delta)
        if v_kept is not None:
            delta = None
            self._store_moments(m, v_kept, generator)

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
