"""Native single-file record store (no external dependencies).

Replaces LMDB when the ``lmdb`` package is unavailable: a ``.rec`` data file
of concatenated pickled records plus a ``.rec.idx`` numpy offset table.
Records are arbitrary picklable objects (typically dicts of numpy arrays),
matching the reference's LMDB record semantics
(``unicore/data/lmdb_dataset.py:47-50``). Reads are mmap-backed and
thread-safe; the per-item LRU cache mirrors the reference.

Copied from ``unicore_tpu/data/indexed_dataset.py`` for the PyTorch port;
the file format is the same, so either package reads the other's stores.
``read_batch`` and ``prefetch`` go through the port's native reader
(:mod:`.record_reader`, ``csrc/record_reader.c``), which the JAX package
has as an optional extension: here it is built at first use, and a
failed build raises.
"""

import logging
import os
import pickle
from functools import lru_cache

import numpy as np

from . import record_reader
from .unicore_dataset import UnicoreDataset

logger = logging.getLogger(__name__)

_MAGIC = b"UTPUREC1"


class DataIntegrityError(RuntimeError):
    """A dataset record that cannot be trusted: truncated data/index
    files, record slices outside the file's extents, or bytes that no
    longer unpickle.  Raised at FIRST touch — the alternative is a
    silently-truncated tensor training the model on garbage."""


class IndexedRecordWriter:
    """Streaming writer: ``with IndexedRecordWriter(path) as w: w.write(obj)``."""

    def __init__(self, path):
        self.path = path
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._offsets = [self._f.tell()]

    def write(self, obj):
        self._f.write(pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL))
        self._offsets.append(self._f.tell())

    def close(self):
        self._f.close()
        np.asarray(self._offsets, dtype=np.int64).tofile(self.path + ".idx")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class IndexedRecordDataset(UnicoreDataset):
    """Reads records written by :class:`IndexedRecordWriter`."""

    def __init__(self, path):
        self.path = path
        assert os.path.isfile(path), f"{path} not found"
        assert os.path.isfile(path + ".idx"), f"{path}.idx not found"
        self._offsets = np.fromfile(path + ".idx", dtype=np.int64)
        with open(path, "rb") as f:
            if f.read(len(_MAGIC)) != _MAGIC:
                raise DataIntegrityError(
                    f"{path}: bad magic — not an IndexedRecordWriter file, "
                    f"or its header bytes are corrupt"
                )
        # validate the offset table against the data file's real extents
        # AT OPEN: a truncated .rec mmaps fine and would otherwise yield
        # silently-truncated pickle bytes; a truncated .idx leaves a
        # final offset short of the file end.  Either way: typed error
        # at first touch, never garbage tensors later.
        size = os.path.getsize(path)
        if len(self._offsets) < 1 or self._offsets[0] != len(_MAGIC):
            raise DataIntegrityError(
                f"{path}.idx: offset table does not start at the header "
                f"({self._offsets[:1]} != {len(_MAGIC)}) — the index file "
                f"is torn or from a different store"
            )
        if np.any(np.diff(self._offsets) < 0):
            raise DataIntegrityError(
                f"{path}.idx: offsets are not monotonically increasing — "
                f"the index file is corrupt"
            )
        if int(self._offsets[-1]) != size:
            raise DataIntegrityError(
                f"{path}: final index offset {int(self._offsets[-1])} != "
                f"file size {size} — the data or index file is truncated "
                f"(torn write / partial copy); re-copy or regenerate the "
                f"pair"
            )
        self._mmap = None

    def _data(self):
        if self._mmap is None:
            self._mmap = np.memmap(self.path, dtype=np.uint8, mode="r")
        return self._mmap

    def __len__(self):
        return len(self._offsets) - 1

    def _record_span(self, idx):
        """Bounds-checked (start, end) byte extents of record ``idx`` —
        validated against BOTH the mapped length (stale index) and the
        file's current on-disk size (a file shrunk after open would
        otherwise SIGBUS on the fault-in of unmapped pages, which no
        except clause can catch)."""
        start, end = int(self._offsets[idx]), int(self._offsets[idx + 1])
        if (not 0 <= start <= end <= len(self._data())
                or end > os.path.getsize(self.path)):
            raise DataIntegrityError(
                f"{self.path}: record {idx} spans [{start}, {end}) outside "
                f"the file's current extents (mapped {len(self._data())}, "
                f"on disk {os.path.getsize(self.path)}) — the data file "
                f"was truncated after open or the index is stale"
            )
        return start, end

    @lru_cache(maxsize=16)
    def __getitem__(self, idx):
        start, end = self._record_span(idx)
        try:
            return pickle.loads(self._data()[start:end].tobytes())
        except (pickle.UnpicklingError, EOFError, ValueError,
                AttributeError, ImportError, IndexError) as e:
            raise DataIntegrityError(
                f"{self.path}: record {idx} (bytes [{start}, {end})) does "
                f"not unpickle — the record is torn: {e}"
            ) from e

    def read_batch(self, indices):
        """Decode several records in one call, their span reads done by
        the native reader with ``pread`` and the GIL released.  Public
        API for direct consumers of the store — the batch loader's own
        native path is ``prefetch`` (fanned down per batch through any
        wrapper stack by ``_EpochStream._load``)."""
        starts = [int(self._offsets[i]) for i in indices]
        lens = [int(self._offsets[i + 1] - self._offsets[i]) for i in indices]
        return [
            self._loads(b, int(i))
            for i, b in zip(indices,
                            record_reader.read_spans(self.path, starts, lens))
        ]

    def _loads(self, raw, idx):
        try:
            return pickle.loads(raw)
        except (pickle.UnpicklingError, EOFError, ValueError,
                AttributeError, ImportError, IndexError) as e:
            raise DataIntegrityError(
                f"{self.path}: record {idx} does not unpickle — the "
                f"record is torn: {e}"
            ) from e

    @property
    def supports_prefetch(self):
        return True

    # readahead is synchronous: cap a single call's warmed volume so a
    # direct whole-shard prefetch can't stall the caller or evict the
    # page cache (the loader's per-batch calls are far below this)
    PREFETCH_BYTE_CAP = 1 << 30

    def prefetch(self, indices):
        """Warm the page cache for these records' spans (native
        readahead: no Python-side memory held, the kernel has the bytes
        hot by the time readers fault them in).  Fan-out callers dedupe
        stacks whose leaves share this store via ``prefetch_target``
        (per-call, thread-safe — concurrent worker threads interleave
        batches, so cross-call state here could not be trusted)."""
        if len(indices) == 0:
            return
        idx = np.unique(np.asarray(list(indices), dtype=np.int64))
        starts = self._offsets[idx]
        lens = self._offsets[idx + 1] - starts
        keep = np.cumsum(lens) <= self.PREFETCH_BYTE_CAP
        if not keep.all():
            logger.info(
                "readahead capped: warming %d of %d bytes for %s",
                int(lens[keep].sum()), int(lens.sum()), self.path,
            )
        touched = record_reader.readahead(self.path, starts[keep],
                                          lens[keep])
        logger.debug("readahead warmed %d bytes of %s", touched, self.path)

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_mmap"] = None  # re-open after fork/pickle
        return state


def find_split(data_dir, split):
    """The path of ``split``'s store in ``data_dir``: ``<split>.lmdb``
    first, then ``<split>.rec`` (either as the file or by its ``.idx``),
    else the bare path — the lookup of the JAX tasks."""
    split_path = os.path.join(data_dir, split)
    for ext in (".lmdb", ".rec"):
        if os.path.exists(split_path + ext) or os.path.exists(
                split_path + ext + ".idx"):
            return split_path + ext
    return split_path


def best_record_dataset(path):
    """Open *path* with whichever backend matches: ``.rec`` native store or
    LMDB file."""
    if path.endswith(".rec") or os.path.isfile(path + ".idx"):
        return IndexedRecordDataset(path)
    from .lmdb_dataset import LMDBDataset

    return LMDBDataset(path)
