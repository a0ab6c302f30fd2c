"""Model registries of the port (counterpart of ``unicore_tpu/models``):

- ``MODEL_REGISTRY``: model name -> model class;
- ``ARCH_MODEL_REGISTRY``: architecture name -> model class;
- ``ARCH_CONFIG_REGISTRY``: architecture name -> args-mutator function.
"""

from .unicore_model import BaseUnicoreModel

MODEL_REGISTRY = {}
ARCH_MODEL_REGISTRY = {}
ARCH_CONFIG_REGISTRY = {}


def build_model(args, task):
    return ARCH_MODEL_REGISTRY[args.arch].build_model(args, task)


def register_model(name):
    """Decorator registering a :class:`BaseUnicoreModel` subclass."""

    def register_model_cls(cls):
        if name in MODEL_REGISTRY:
            raise ValueError(f"Cannot register duplicate model ({name})")
        if not issubclass(cls, BaseUnicoreModel):
            raise ValueError(
                f"Model ({name}: {cls.__name__}) must extend BaseUnicoreModel")
        MODEL_REGISTRY[name] = cls
        return cls

    return register_model_cls


def register_model_architecture(model_name, arch_name):
    """Decorator registering an architecture preset: a function that fills
    the parsed args namespace with the architecture's defaults."""

    def register_model_arch_fn(fn):
        if model_name not in MODEL_REGISTRY:
            raise ValueError("Cannot register model architecture for unknown "
                             f"model type ({model_name})")
        if arch_name in ARCH_MODEL_REGISTRY:
            raise ValueError(
                f"Cannot register duplicate model architecture ({arch_name})")
        ARCH_MODEL_REGISTRY[arch_name] = MODEL_REGISTRY[model_name]
        ARCH_CONFIG_REGISTRY[arch_name] = fn
        return fn

    return register_model_arch_fn


__all__ = ["ARCH_CONFIG_REGISTRY", "ARCH_MODEL_REGISTRY", "BaseUnicoreModel",
           "MODEL_REGISTRY", "build_model", "register_model",
           "register_model_architecture"]
