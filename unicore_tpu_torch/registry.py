"""Generic component registries (a copy of the JAX package's
``registry.py``): a decorator registers a class under a string name,
enforcing a base class; ``build_x(args, ...)`` dispatches on
``getattr(args, flag)``; ``set_defaults`` harvests a registered class's
``add_args`` defaults into the parsed namespace.
"""

import argparse

# flag-name -> {"registry": dict, "default": str, "base_class": type}
REGISTRIES = {}


def setup_registry(registry_name: str, base_class=None, default=None, required=False):
    assert registry_name.startswith("--"), registry_name
    clean_name = registry_name[2:].replace("-", "_")

    registry = {}
    registered_class_names = set()

    if clean_name in REGISTRIES:
        raise ValueError(f"registry {clean_name} already exists")
    REGISTRIES[clean_name] = {
        "registry": registry,
        "default": default,
        "base_class": base_class,
    }

    def build_x(args, *extra_args, **extra_kwargs):
        choice = getattr(args, clean_name, None)
        if choice is None:
            if required:
                raise ValueError(f"--{clean_name.replace('_', '-')} is required")
            return None
        if choice not in registry:
            raise ValueError(
                f"unknown {clean_name} '{choice}' (choices: {sorted(registry)})"
            )
        cls = registry[choice]
        builder = getattr(cls, "build_" + clean_name, cls)
        return builder(args, *extra_args, **extra_kwargs)

    def register_x(name):
        def wrapper(cls):
            if name in registry:
                raise ValueError(f"cannot register duplicate {clean_name} ({name})")
            if base_class is not None and not issubclass(cls, base_class):
                raise ValueError(
                    f"{clean_name} ({name}: {cls.__name__}) must extend "
                    f"{base_class.__name__}"
                )
            if cls.__name__ in registered_class_names:
                raise ValueError(
                    f"cannot register {clean_name} with duplicate class name "
                    f"({cls.__name__})"
                )
            registry[name] = cls
            registered_class_names.add(cls.__name__)
            return cls

        return wrapper

    return build_x, register_x, registry


def set_defaults(args, cls):
    """Copy the defaults declared by ``cls.add_args`` onto *args* for any
    attribute not already set (mirrors ``unicore/registry.py:66``)."""
    if not hasattr(cls, "add_args"):
        return
    parser = argparse.ArgumentParser(argument_default=argparse.SUPPRESS, allow_abbrev=False)
    cls.add_args(parser)
    defaults = argparse.Namespace()
    for action in parser._actions:
        if action.dest is not argparse.SUPPRESS and action.dest != "help":
            if not hasattr(defaults, action.dest) and action.default is not argparse.SUPPRESS:
                setattr(defaults, action.dest, action.default)
    for key, default_value in vars(defaults).items():
        if not hasattr(args, key):
            setattr(args, key, default_value)
