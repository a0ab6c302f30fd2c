"""Running-statistic meters for training metrics.

Behavioral parity target: the meter taxonomy of
``unicore/logging/meters.py`` — a weighted average, a raw sum, an
events-per-second rate, a stopwatch, and a priority-ordered serializable
collection with derived (computed-from-other-meters) entries.  Independent
implementation: every concrete meter derives from one `_ScalarMeter` base
that owns rounding and state (de)serialization declaratively, and the
collection is a plain mapping that sorts on demand instead of maintaining
insertion order imperatively.  Values may be python numbers, numpy scalars,
or jax scalars; all are coerced to floats on entry.
"""

import time
from typing import Callable, Dict, Optional


def as_float(x):
    """Coerce python/numpy/jax scalars to a python float (None passes)."""
    if x is None:
        return None
    item = getattr(x, "item", None)
    if item is not None:
        try:
            return float(item())
        except Exception:
            pass
    return float(x)


def safe_round(number, ndigits):
    """Round plain numbers; pass anything exotic through untouched."""
    number = as_float(number) if hasattr(number, "item") else number
    if isinstance(number, (int, float)):
        return round(number, ndigits)
    return number


class Meter:
    """Meter interface: update somehow, read ``smoothed_value``."""

    def reset(self):
        raise NotImplementedError

    def state_dict(self):
        return {}

    def load_state_dict(self, state_dict):
        pass

    @property
    def smoothed_value(self) -> float:
        raise NotImplementedError


class _ScalarMeter(Meter):
    """Base for meters whose state is a fixed set of scalar fields.

    Subclasses declare ``_FIELDS`` (serialized attributes) and implement
    ``_read()``; rounding and state round-trip live here once.
    """

    _FIELDS = ()

    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.reset()

    def _read(self):
        raise NotImplementedError

    @property
    def smoothed_value(self) -> float:
        v = self._read()
        if self.round is not None and v is not None:
            v = safe_round(v, self.round)
        return v

    def state_dict(self):
        out = {name: getattr(self, name) for name in self._FIELDS}
        out["round"] = self.round
        return out

    def load_state_dict(self, state_dict):
        self.reset()
        for name in self._FIELDS:
            if name in state_dict:
                setattr(self, name, state_dict[name])
        self.round = state_dict.get("round", None)


class AverageMeter(_ScalarMeter):
    """Weighted running average; also remembers the latest raw value."""

    _FIELDS = ("val", "sum", "count")

    def reset(self):
        self.val = None
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n=1):
        if val is None:
            return
        val, n = as_float(val), as_float(n)
        self.val = val
        if n > 0:
            self.sum += val * n
            self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count > 0 else self.val

    def _read(self):
        return self.avg


class SumMeter(_ScalarMeter):
    """Plain accumulator."""

    _FIELDS = ("sum",)

    def reset(self):
        self.sum = 0.0

    def update(self, val):
        if val is not None:
            self.sum += as_float(val)

    def _read(self):
        return self.sum


class TimeMeter(_ScalarMeter):
    """Rate meter: events per second of wall time since reset.

    Serializes elapsed time (not the clock origin) so a resumed run
    continues the rate from where the checkpoint left off.
    """

    _FIELDS = ()  # custom state: elapsed is computed at save time

    def __init__(self, init: float = 0, n: float = 0,
                 round: Optional[int] = None):
        self.round = round
        self.reset(init, n)

    def reset(self, init=0, n=0):
        self.init = init
        self.n = n
        self.i = 0
        self._origin = time.perf_counter()

    def update(self, val=1):
        self.n += as_float(val)
        self.i += 1

    @property
    def elapsed_time(self):
        return self.init + (time.perf_counter() - self._origin)

    @property
    def avg(self):
        t = self.elapsed_time
        return self.n / t if t > 0 else 0.0

    def _read(self):
        return self.avg

    def state_dict(self):
        return {"init": self.elapsed_time, "n": self.n, "round": self.round}

    def load_state_dict(self, state_dict):
        if "start" in state_dict:  # pre-fix checkpoints carried a clock origin
            self.reset(init=state_dict["init"])
        else:
            self.reset(init=state_dict.get("init", 0), n=state_dict.get("n", 0))
            self.round = state_dict.get("round", None)


class StopwatchMeter(_ScalarMeter):
    """Accumulates durations between start()/stop() pairs.

    Reads as the average duration per weighted stop once any interval has
    been recorded, else as the currently-running elapsed time.
    """

    _FIELDS = ("sum", "n")

    def __init__(self, round: Optional[int] = None):
        self.round = round
        self.sum = 0.0
        self.n = 0.0
        self._started_at = None

    def start(self):
        self._started_at = time.perf_counter()

    def stop(self, n=1, prehook=None):
        if self._started_at is None:
            return
        if prehook is not None:
            prehook()
        self.sum += time.perf_counter() - self._started_at
        self.n += as_float(n)

    def reset(self):
        self.sum = 0.0
        self.n = 0.0
        self.start()

    @property
    def avg(self):
        return self.sum / self.n if self.n > 0 else self.sum

    @property
    def elapsed_time(self):
        if self._started_at is None:
            return 0.0
        return time.perf_counter() - self._started_at

    def _read(self):
        return self.avg if self.sum > 0 else self.elapsed_time

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        self._started_at = None


class MetersDict:
    """Mapping of named meters ordered by (priority, insertion sequence).

    A meter's priority is fixed when it is first added; re-adding an
    existing key is an error.  Derived meters (computed from the other
    meters at read time) are supported via :class:`MetersDict._DerivedMeter`
    and are skipped during serialization.
    """

    class _DerivedMeter(Meter):
        """Reads as ``fn(meters_dict)``; holds no state of its own."""

        def __init__(self, fn: Callable[["MetersDict"], float]):
            self.fn = fn

        def reset(self):
            pass

    def __init__(self):
        self._meters: Dict[str, Meter] = {}
        self._rank: Dict[str, tuple] = {}  # key -> (priority, seq)
        self._seq = 0

    # mapping protocol (ordered by priority) ---------------------------

    def _ordered_keys(self):
        return sorted(self._meters, key=self._rank.__getitem__)

    def __contains__(self, key):
        return key in self._meters

    def __getitem__(self, key):
        return self._meters[key]

    def get(self, key, default=None):
        return self._meters.get(key, default)

    def __len__(self):
        return len(self._meters)

    def __iter__(self):
        return iter(self._ordered_keys())

    def keys(self):
        return self._ordered_keys()

    def values(self):
        return [self._meters[k] for k in self._ordered_keys()]

    def items(self):
        return [(k, self._meters[k]) for k in self._ordered_keys()]

    def clear(self):
        self._meters.clear()
        self._rank.clear()
        self._seq = 0

    # meter registration / reads ---------------------------------------

    def add_meter(self, key, meter: Meter, priority):
        assert key not in self._meters, (
            f"meter {key!r} already registered; priorities are fixed at "
            "first registration"
        )
        self._meters[key] = meter
        self._rank[key] = (priority, self._seq)
        self._seq += 1

    def get_smoothed_value(self, key: str) -> float:
        meter = self._meters[key]
        if isinstance(meter, MetersDict._DerivedMeter):
            return meter.fn(self)
        return meter.smoothed_value

    def get_smoothed_values(self) -> Dict[str, float]:
        return {
            key: self.get_smoothed_value(key)
            for key in self._ordered_keys()
            if not key.startswith("_")
        }

    def reset(self):
        for meter in self._meters.values():
            meter.reset()

    # serialization (derived meters are reconstructed by their loggers) -

    def state_dict(self):
        return [
            (self._rank[key][0], self._rank[key][1], key,
             type(meter).__name__, meter.state_dict())
            for key, meter in self.items()
            if not isinstance(meter, MetersDict._DerivedMeter)
        ]

    def load_state_dict(self, state_dict):
        self.clear()
        for priority, _, key, cls_name, meter_state in state_dict:
            meter = globals()[cls_name]()
            meter.load_state_dict(meter_state)
            self.add_meter(key, meter, priority)
