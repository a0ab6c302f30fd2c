"""Pass-through schedule (a copy of the JAX package's ``pass_through.py``):
every scheduler hook is forwarded to a scheduler the optimizer itself
owns.  No optimizer of either package owns one, so it raises the JAX
``ValueError`` when it is built."""

from . import register_lr_scheduler
from .unicore_lr_scheduler import UnicoreLRScheduler


def _forward(name):
    def method(self, *args, **kwargs):
        return getattr(self.optimizer.lr_scheduler, name)(*args, **kwargs)

    method.__name__ = name
    method.__doc__ = f"Forward ``{name}`` to the optimizer-owned scheduler."
    return method


@register_lr_scheduler("pass_through")
class PassThroughScheduleSchedule(UnicoreLRScheduler):
    def __init__(self, args, optimizer, total_train_steps):
        super().__init__(args, optimizer, total_train_steps)
        if getattr(optimizer, "lr_scheduler", None) is None:
            raise ValueError(
                "pass_through requires an optimizer that owns its scheduler"
            )


for _name in ("state_dict", "load_state_dict", "step_begin_epoch", "step",
              "step_update"):
    setattr(PassThroughScheduleSchedule, _name, _forward(_name))
del _name
