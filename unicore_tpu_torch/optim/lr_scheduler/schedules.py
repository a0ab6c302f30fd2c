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
