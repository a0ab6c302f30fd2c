"""Progress reporting over batch iterators (a copy of
``unicore_tpu/logging/progress_bar.py``, which imports no framework; the
port imports nothing of the JAX package).

``--log-format`` picks the renderer: ``json``, ``simple``, ``tqdm`` (on a
TTY only; ``simple`` elsewhere) or ``none``.  Iteration bookkeeping and
interval gating live once in the base class and each renderer only
implements the two emit hooks (interval line, end-of-epoch summary).

``--tensorboard-logdir`` differs from the JAX package's wrapper, which
writes TensorBoard event files: here every ``log``/``print`` call appends
one JSON line, ``{"step": N, **stats}``, to ``<logdir>/<tag>.jsonl``.  A
training host of the port has no TensorBoard writer, and the records are
what scripts read back (``chip_smoke.py`` among them).

Stats arrive as dicts whose values are numbers, numpy/torch scalars, or
Meter objects; rendering coerces them on the way out.
"""

import json
import logging
import os
import sys
from numbers import Number

from .meters import AverageMeter, StopwatchMeter, TimeMeter

logger = logging.getLogger(__name__)


def progress_bar(iterator, log_format=None, log_interval=100, epoch=None,
                 prefix=None, tensorboard_logdir=None,
                 default_log_format="tqdm"):
    """Build the renderer selected by ``--log-format``."""
    fmt = log_format or default_log_format
    if fmt == "tqdm" and not sys.stderr.isatty():
        fmt = "simple"
    renderers = {
        "json": JsonProgressBar,
        "simple": SimpleProgressBar,
        "tqdm": TqdmProgressBar,
        "none": NoopProgressBar,
    }
    if fmt not in renderers:
        raise ValueError(
            f"unknown log format {fmt!r}; expected one of {sorted(renderers)}"
        )
    bar = renderers[fmt](iterator, epoch=epoch, prefix=prefix,
                         log_interval=log_interval)
    if tensorboard_logdir:
        bar = JsonlRecordWrapper(bar, tensorboard_logdir)
    return bar


def format_stat(value):
    """Render one stat value as a short string (Meters read their summary)."""
    if isinstance(value, Number):
        return f"{value:g}"
    if isinstance(value, AverageMeter):
        return f"{value.avg:.3f}"
    if isinstance(value, TimeMeter):
        return f"{round(value.avg):g}"
    if isinstance(value, StopwatchMeter):
        return f"{round(value.sum):g}"
    if hasattr(value, "item"):
        return f"{value.item():g}"
    return value


class BaseProgressBar:
    """Common machinery: position/size tracking, interval gating, labels."""

    def __init__(self, iterable, epoch=None, prefix=None, log_interval=100):
        self.iterable = iterable
        self.offset = getattr(iterable, "n", 0)
        self.epoch = epoch
        self.log_interval = log_interval
        self.i = None
        self.size = None
        parts = []
        if epoch is not None:
            parts.append(f"epoch {epoch:03d}")
        if prefix is not None:
            parts.append(prefix)
        self.prefix = " | ".join(parts)

    def __len__(self):
        return len(self.iterable)

    def __iter__(self):
        self.size = len(self.iterable)
        for i, obj in enumerate(self.iterable, start=self.offset):
            self.i = i
            yield obj

    # renderer hooks ---------------------------------------------------

    def _emit_log(self, rendered):
        raise NotImplementedError

    def _emit_print(self, rendered):
        raise NotImplementedError

    # public API -------------------------------------------------------

    def log(self, stats, tag=None, step=None):
        """Emit an intermediate line every ``log_interval`` steps."""
        step = step or self.i or 0
        if (step > 0 and self.log_interval is not None
                and step % self.log_interval == 0):
            self._emit_log(self._render(stats))

    def print(self, stats, tag=None, step=None):
        """Emit the end-of-epoch summary line."""
        self._emit_print(self._render(stats))

    def _render(self, stats):
        return {k: str(format_stat(v)) for k, v in stats.items()}


class NoopProgressBar(BaseProgressBar):
    """Silent renderer for --log-format none."""

    def __iter__(self):
        return iter(self.iterable)

    def log(self, stats, tag=None, step=None):
        pass

    def print(self, stats, tag=None, step=None):
        pass


class SimpleProgressBar(BaseProgressBar):
    """Plain log lines; the default off-TTY."""

    def _emit_log(self, rendered):
        body = ", ".join(f"{k}={v}" for k, v in rendered.items())
        pos = (self.i + 1) if self.i is not None else 0
        logger.info("%s:  %5d / %d %s", self.prefix, pos, self.size or 0, body)

    def _emit_print(self, rendered):
        body = " | ".join(f"{k} {v}" for k, v in rendered.items())
        logger.info("%s | %s", self.prefix, body)


class JsonProgressBar(BaseProgressBar):
    """One JSON object per line, with fractional epoch progress."""

    def log(self, stats, tag=None, step=None):
        step = step or self.i or 0
        if (step > 0 and self.log_interval is not None
                and step % self.log_interval == 0):
            record = {}
            if self.epoch is not None:
                record["epoch"] = self.epoch
                if self.size:
                    record["update"] = round(
                        self.epoch - 1 + (self.i + 1) / float(self.size), 3
                    )
            record.update((k, format_stat(v)) for k, v in stats.items())
            logger.info(json.dumps(record))

    def print(self, stats, tag=None, step=None):
        if tag is not None:
            stats = {f"{tag}_{k}": v for k, v in stats.items()}
        record = {} if self.epoch is None else {"epoch": self.epoch}
        record.update((k, format_stat(v)) for k, v in stats.items())
        logger.info(json.dumps(record))


class TqdmProgressBar(BaseProgressBar):
    """Interactive bar for TTY sessions."""

    def __init__(self, iterable, epoch=None, prefix=None, log_interval=100):
        super().__init__(iterable, epoch, prefix, log_interval)
        from tqdm import tqdm

        self.tqdm = tqdm(
            iterable, self.prefix, leave=False,
            disable=(logger.getEffectiveLevel() > logging.INFO),
        )

    def __iter__(self):
        return iter(self.tqdm)

    def log(self, stats, tag=None, step=None):
        self.tqdm.set_postfix(self._render(stats), refresh=False)

    def print(self, stats, tag=None, step=None):
        body = " | ".join(f"{k} {v}" for k, v in self._render(stats).items())
        self.tqdm.write(f"{self.tqdm.desc} | {body}")


class JsonlRecordWrapper:
    """Append every logged stats dict to ``<logdir>/<tag>.jsonl`` as one
    JSON line, ``{"step": N, **stats}``, then delegate to the bar."""

    def __init__(self, wrapped_bar, logdir):
        self.wrapped_bar = wrapped_bar
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)

    def _record(self, stats, tag, step):
        if step is None:
            step = stats.get("num_updates", -1)
        path = os.path.join(self.logdir, f"{tag or ''}.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps({"step": step, **stats}) + "\n")

    def __len__(self):
        return len(self.wrapped_bar)

    def __iter__(self):
        return iter(self.wrapped_bar)

    def log(self, stats, tag=None, step=None):
        self._record(stats, tag, step)
        self.wrapped_bar.log(stats, tag=tag, step=step)

    def print(self, stats, tag=None, step=None):
        self._record(stats, tag, step)
        self.wrapped_bar.print(stats, tag=tag, step=step)
