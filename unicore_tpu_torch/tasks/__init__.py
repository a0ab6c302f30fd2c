"""Task registry of the port, keyed by ``--task``."""

from .unicore_task import UnicoreTask

TASK_REGISTRY = {}


def setup_task(args, **kwargs):
    return TASK_REGISTRY[args.task].setup_task(args, **kwargs)


def register_task(name):
    """Decorator registering a :class:`UnicoreTask` subclass."""

    def register_task_cls(cls):
        if name in TASK_REGISTRY:
            raise ValueError(f"Cannot register duplicate task ({name})")
        if not issubclass(cls, UnicoreTask):
            raise ValueError(
                f"Task ({name}: {cls.__name__}) must extend UnicoreTask")
        TASK_REGISTRY[name] = cls
        return cls

    return register_task_cls


__all__ = ["TASK_REGISTRY", "UnicoreTask", "register_task", "setup_task"]
