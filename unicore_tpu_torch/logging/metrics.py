"""Global metrics aggregation with nested contexts.

Covers the contract of the reference's ``unicore/logging/metrics.py``:
``aggregate(name)`` context managers stack :class:`MetersDict` aggregators so
one ``log_scalar`` call fans out to every active aggregator; named aggregators
("train", "valid", ...) persist across steps and are checkpointable via
``state_dict``/``load_state_dict``.  Scalars may be jax/numpy device values —
they are coerced to floats at log time (forcing a host sync; the trainer only
logs already-fetched step outputs, so the hot path stays async).

Internals differ from the reference on purpose: instead of a refcounted
active-set dict that ``new_root`` backs up and restores around the scope,
the module keeps ONE explicit stack of open scopes.  A ``new_root`` scope
pushes a barrier sentinel; the active set is simply everything above the
topmost barrier (plus the implicit "default" aggregator when no barrier is
open).  Exiting a scope truncates the stack back to its entry depth, which
makes cleanup exception-safe for free.
"""

import contextlib
from typing import Callable, Dict, List, Optional

from .meters import (
    AverageMeter,
    Meter,
    MetersDict,
    StopwatchMeter,
    SumMeter,
    TimeMeter,
)

#: persistent aggregators by name ("default" is created by :func:`reset`)
_named: Dict[str, MetersDict] = {}

#: open scopes, innermost last.  Each entry is ``(token, MetersDict)``;
#: ``token`` is the scope name for named scopes (so re-entering "train"
#: dedupes to one fan-out target), a fresh object() for anonymous scopes,
#: and :data:`_BARRIER` for the sentinel a ``new_root`` scope pushes.
_scopes: list = []

_BARRIER = object()


def reset() -> None:
    """Drop every aggregator and open scope; recreate the default."""
    _named.clear()
    _scopes.clear()
    _named["default"] = MetersDict()


@contextlib.contextmanager
def aggregate(name: Optional[str] = None, new_root: bool = False):
    """Open an aggregation scope.

    While the scope is open, every ``log_*`` call lands in this aggregator
    as well as all enclosing ones (and "default").  Scopes nest; a *named*
    scope reuses the persistent :class:`MetersDict` registered under that
    name, while an anonymous scope gets a throwaway one.  With
    ``new_root=True`` the scope hides everything outside itself — logged
    values reach only aggregators opened within it (used to keep validation
    stats out of the train meters).
    """
    if name == "default":
        raise ValueError("'default' is implicit and cannot be opened")
    if name is None:
        token, agg = object(), MetersDict()  # anonymous: dies with the scope
    else:
        token, agg = name, _named.setdefault(name, MetersDict())
    depth = len(_scopes)
    if new_root:
        _scopes.append((_BARRIER, None))
    _scopes.append((token, agg))
    try:
        yield agg
    finally:
        del _scopes[depth:]


def get_active_aggregators() -> List[MetersDict]:
    """Aggregators the next ``log_*`` call will reach: everything above the
    topmost barrier, deduped by token, plus "default" when unbarriered."""
    top = next(
        (i + 1 for i in range(len(_scopes) - 1, -1, -1)
         if _scopes[i][0] is _BARRIER),
        None,
    )
    active = {} if top is not None else {"default": _named["default"]}
    active.update((tok, agg) for tok, agg in _scopes[top or 0:])
    return list(active.values())


def _reach(key: str, make_meter: Callable[[], Meter], priority: int):
    """Yield the meter registered under *key* in each active aggregator,
    creating it via *make_meter* on first touch."""
    for agg in get_active_aggregators():
        if key not in agg:
            agg.add_meter(key, make_meter(), priority)
        yield agg[key]


def log_scalar(key: str, value: float, weight: float = 1, priority: int = 10,
               round: Optional[int] = None):
    """Log a scalar into every active aggregator (weighted average).

    A key held by a derived meter (``log_derived``) is left alone: its
    value is recomputed from other meters at read time, so a scalar
    arriving under the same name (e.g. the trainer re-logging a reduced
    stats dict that includes derived entries) must not clobber it."""
    for meter in _reach(key, lambda: AverageMeter(round=round), priority):
        if not isinstance(meter, MetersDict._DerivedMeter):
            meter.update(value, weight)


def log_scalar_sum(key: str, value: float, priority: int = 10,
                   round: Optional[int] = None):
    """Log a scalar accumulated as a raw sum."""
    for meter in _reach(key, lambda: SumMeter(round=round), priority):
        meter.update(value)


def log_derived(key: str, fn: Callable[[MetersDict], float],
                priority: int = 20):
    """Register a value computed from other meters at read time."""
    for _ in _reach(key, lambda: MetersDict._DerivedMeter(fn), priority):
        pass  # registration only; nothing to update


def log_speed(key: str, value: float, priority: int = 30,
              round: Optional[int] = None):
    """Log the rate of some quantity per second."""
    for agg in get_active_aggregators():
        if key in agg:
            agg[key].update(value)
        else:
            agg.add_meter(key, TimeMeter(round=round), priority)
            agg[key].reset()  # the first call only starts the clock


def log_start_time(key: str, priority: int = 40,
                   round: Optional[int] = None):
    """Start a stopwatch under *key*."""
    for meter in _reach(key, lambda: StopwatchMeter(round=round), priority):
        meter.start()


def log_stop_time(key: str, weight: float = 0.0, prehook=None):
    """Stop the stopwatch under *key* (no-op where it was never started)."""
    for agg in get_active_aggregators():
        if key in agg:
            agg[key].stop(weight, prehook)


def log_custom(new_meter_fn: Callable[[], Meter], key: str, *args,
               priority: int = 50, **kwargs):
    """Log through a caller-supplied Meter type."""
    for meter in _reach(key, new_meter_fn, priority):
        meter.update(*args, **kwargs)


def reset_meter(name: str, key: str) -> None:
    meter = get_meter(name, key)
    if meter is not None:
        meter.reset()


def reset_meters(name: str) -> None:
    meters = get_meters(name)
    if meters is not None:
        meters.reset()


def get_meter(name: str, key: str) -> Optional[Meter]:
    agg = _named.get(name)
    return agg.get(key, None) if agg is not None else None


def get_meters(name: str) -> Optional[MetersDict]:
    return _named.get(name, None)


def get_smoothed_value(name: str, key: str) -> float:
    return _named[name].get_smoothed_value(key)


def get_smoothed_values(name: str) -> Dict[str, float]:
    return _named[name].get_smoothed_values()


def state_dict():
    return {name: agg.state_dict() for name, agg in _named.items()}


def load_state_dict(state_dict):
    for name, agg_state in state_dict.items():
        _named[name] = MetersDict()
        _named[name].load_state_dict(agg_state)


reset()
