"""Pure ``step -> lr`` schedule functions (the host-side half of
``unicore_tpu/optim/lr_scheduler/schedules.py`` the port's schedulers
need)."""

import math


def polynomial_decay(step, *, base_lr, end_lr, power, warmup_updates,
                     total_updates):
    """Linear warmup to ``base_lr`` then polynomial decay to ``end_lr`` at
    ``total_updates``."""
    if warmup_updates > 0 and step <= warmup_updates:
        return (step / float(warmup_updates)) * base_lr
    if step >= total_updates:
        return end_lr
    denom = max(total_updates - warmup_updates, 1)
    pct_remaining = 1.0 - (step - warmup_updates) / denom
    return (base_lr - end_lr) * pct_remaining ** power + end_lr


def fixed_warmup(step, *, base_lr, warmup_updates):
    """Linear warmup onto the (epoch-driven) base LR."""
    if warmup_updates > 0 and step < warmup_updates:
        return ((step + 1) / float(warmup_updates)) * base_lr
    return base_lr


def exponential_decay(step, *, base_lr, decay_ratio, decay_steps,
                      warmup_updates, stair=False):
    """Linear warmup to ``base_lr``, then ``base_lr * decay_ratio **
    exponent``: ``(step - warmup_updates) / decay_steps``, or under
    ``stair`` ``floor(step / decay_steps)`` (the reference's staircase
    counts from step 0, not from the warmup's end)."""
    if warmup_updates > 0 and step <= warmup_updates:
        return (step / float(warmup_updates)) * base_lr
    if stair:
        exponent = math.floor(step / decay_steps)
    else:
        exponent = (step - warmup_updates) / float(decay_steps)
    return base_lr * decay_ratio ** exponent


def inverse_sqrt(step, *, base_lr, warmup_updates, warmup_init_lr):
    """Linear warmup from ``warmup_init_lr``, then lr ~ 1/sqrt(step).
    Without warmup the reference divides by 0 (ZeroDivisionError), as
    the reference's scheduler does."""
    lr_step = (base_lr - warmup_init_lr) / warmup_updates
    decay_factor = base_lr * warmup_updates ** 0.5
    if step < warmup_updates:
        return warmup_init_lr + step * lr_step
    return decay_factor * (1e-30 + step) ** -0.5


def cosine(step, *, max_lr, min_lr, period, t_mult, shrink,
           warmup_updates, warmup_init_lr):
    """Warmup then cyclical cosine annealing (SGDR, arxiv 1608.03983):
    ``t_mult`` grows each period; ``shrink`` scales both bounds per
    completed cycle."""
    t = step - warmup_updates
    t = t if t > 0 else 0 * t  # the cycle start during warmup
    if t_mult != 1:
        i = math.floor(math.log(1 - t / period * (1 - t_mult))
                       / math.log(t_mult))
        t_i = t_mult ** i * period
        t_curr = t - (1 - t_mult ** i) / (1 - t_mult) * period
    else:
        i = math.floor(t / period)
        t_i = period
        t_curr = t - period * i
    cycle_shrink = shrink ** i
    lo, hi = min_lr * cycle_shrink, max_lr * cycle_shrink
    annealed = lo + 0.5 * (hi - lo) * (1 + math.cos(math.pi * t_curr / t_i))
    if warmup_updates > 0 and step < warmup_updates:
        return warmup_init_lr + step * (max_lr - warmup_init_lr) / warmup_updates
    return annealed


def triangular(step, *, min_lr, max_lr, stepsize, shrink, shrink_min):
    """Cyclical triangular LR (CLR, arxiv 1506.01186)."""
    cycle = math.floor(step / (2 * stepsize))
    cycle_shrink = shrink ** cycle
    hi = max_lr * cycle_shrink
    lo = min_lr * cycle_shrink if shrink_min else min_lr
    x = abs(step / stepsize - 2 * (cycle + 1) + 1)
    frac = 1 - x if 1 - x > 0 else 0.0
    return lo + (hi - lo) * frac


def tri_stage(step, *, init_lr, peak_lr, final_lr, warmup_steps, hold_steps,
              decay_steps, decay_factor):
    """Warmup -> hold -> exponential decay -> floor (SpecAugment, arxiv
    1904.08779); the decay stage includes its last step."""
    if step < warmup_steps:
        return init_lr + (peak_lr - init_lr) * (step / warmup_steps)
    if step < warmup_steps + hold_steps:
        return peak_lr
    if step <= warmup_steps + hold_steps + decay_steps:
        t_decay = step - warmup_steps - hold_steps
        return peak_lr * math.exp(-decay_factor * t_decay)
    return final_lr
