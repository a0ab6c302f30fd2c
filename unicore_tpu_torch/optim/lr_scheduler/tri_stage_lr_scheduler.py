"""Tri-stage (warmup/hold/decay) LR: thin shim over
``schedules.tri_stage`` (SpecAugment, arxiv 1904.08779), as the JAX
package's ``tri_stage_lr_scheduler.py``: the same flags, defaults and
errors, ``--phase-ratio`` read by ``ast.literal_eval``, never ``eval``."""

import ast
import functools
import math

from . import register_lr_scheduler
from .schedules import tri_stage
from .unicore_lr_scheduler import FunctionalLRScheduler


@register_lr_scheduler("tri_stage")
class TriStageLRSchedule(FunctionalLRScheduler):
    @classmethod
    def add_args(cls, parser):
        parser.add_argument('--warmup-steps', default=4000, type=int, metavar='N',
                            help='warmup the learning rate linearly for the first N updates')
        parser.add_argument('--hold-steps', default=20000, type=int, metavar='N',
                            help='steps in hold stage')
        parser.add_argument('--decay-steps', default=60000, type=int, metavar='N',
                            help='steps in decay stage')
        parser.add_argument('--phase-ratio', default=None,
                            help='ratio for all stages, e.g. "(0.1, 0.4, 0.5)"')
        parser.add_argument('--init-lr-scale', default=0.01, type=float,
                            help='initial learning rate scale during warmup phase')
        parser.add_argument('--final-lr-scale', default=0.01, type=float,
                            help='final learning rate scale')

    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        if len(args.lr) > 1:
            raise ValueError(
                "Cannot use a fixed learning rate schedule with tri-stage lr;"
                " consider --lr-scheduler=fixed instead."
            )
        peak = args.lr[0]
        if args.phase_ratio is not None:
            if not args.max_update > 0:
                raise ValueError("--phase-ratio needs --max-update")
            ratios = (
                ast.literal_eval(args.phase_ratio)  # never eval() user input
                if isinstance(args.phase_ratio, str) else args.phase_ratio
            )
            if sum(ratios) != 1:
                raise ValueError("phase ratios must add up to 1")
            warmup, hold, decay = (int(args.max_update * r) for r in ratios)
        else:
            warmup, hold, decay = (
                args.warmup_steps, args.hold_steps, args.decay_steps
            )
        if warmup + hold + decay <= 0:
            raise ValueError("please specify steps or phase_ratio")
        self._schedule = functools.partial(
            tri_stage,
            init_lr=args.init_lr_scale * peak, peak_lr=peak,
            final_lr=args.final_lr_scale * peak,
            warmup_steps=warmup, hold_steps=hold, decay_steps=decay,
            decay_factor=-math.log(args.final_lr_scale) / max(decay, 1),
        )
        self.lr = args.init_lr_scale * peak
        self.optimizer.set_lr(self.lr)
