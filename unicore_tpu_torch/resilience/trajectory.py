"""Per-update loss-trajectory writer (counterpart of
``unicore_tpu/resilience/trajectory.py``; the same JSON lines, so one
reader parses both packages' files).

One JSON line per processed step — applied updates and anomalous skips
alike — with the loss at full precision (``repr`` of the float64 widening
of the fp32 scalar is exact), so two runs compare bit for bit.  The file
is opened for appending and flushed per line: a SIGKILL loses at most
the line being written, and a resumed run appends after the lines the
killed run already wrote."""

import json
import logging
import os

logger = logging.getLogger(__name__)


class TrajectoryWriter:
    def __init__(self, path):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")

    def record(self, **fields):
        """Write one step record; floats serialize via repr (exact)."""
        self._fh.write(json.dumps(fields, sort_keys=True) + "\n")
        self._fh.flush()

    def close(self):
        try:
            self._fh.close()
        except OSError:
            logger.warning("trajectory file close failed", exc_info=True)


def read_trajectory(path):
    """Parse a trajectory file -> list of dicts (a torn last line, what a
    SIGKILL mid-write leaves, is dropped)."""
    records = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                logger.warning("dropping torn trajectory line in %s", path)
    return records
