"""LMDB-backed dataset (a copy of ``unicore_tpu/data/lmdb_dataset.py``;
reference: unicore/data/lmdb_dataset.py:16-50).

Reads pickled records from a single-file LMDB. Keys are scanned eagerly at
construction; each worker lazily (re)connects its own environment so the
dataset is fork/thread-safe; ``__getitem__`` carries a small LRU cache.

The ``lmdb`` package is optional in this build — when absent, constructing
:class:`LMDBDataset` raises with a pointer to :class:`IndexedRecordDataset`
(the native record store with identical record semantics).
"""

import os
import pickle
from functools import lru_cache

from .indexed_dataset import DataIntegrityError
from .unicore_dataset import UnicoreDataset

try:
    import lmdb

    _HAS_LMDB = True
except ImportError:
    _HAS_LMDB = False


class LMDBDataset(UnicoreDataset):
    def __init__(self, db_path):
        if not _HAS_LMDB:
            raise ImportError(
                "the 'lmdb' package is not installed; either install it or "
                "convert your data with "
                "unicore_tpu_torch.data.IndexedRecordDataset "
                "(same pickled-record semantics, no external dependency)"
            )
        self.db_path = db_path
        assert os.path.isfile(self.db_path), f"{self.db_path} not found"
        env = self.connect_db(self.db_path)
        with env.begin() as txn:
            self._keys = list(txn.cursor().iternext(values=False))
        env.close()
        self._env = None

    def connect_db(self, lmdb_path, save_to_self=False):
        env = lmdb.open(
            lmdb_path,
            subdir=False,
            readonly=True,
            lock=False,
            readahead=False,
            meminit=False,
            max_readers=256,
        )
        if not save_to_self:
            return env
        self._env = env

    def __len__(self):
        return len(self._keys)

    @lru_cache(maxsize=16)
    def __getitem__(self, idx):
        if self._env is None:
            self.connect_db(self.db_path, save_to_self=True)
        try:
            datapoint_pickled = self._env.begin().get(self._keys[idx])
        except lmdb.Error as e:  # torn page / failed read
            raise DataIntegrityError(
                f"{self.db_path}: LMDB read failed for record {idx} "
                f"(key {self._keys[idx]!r}): {e}"
            ) from e
        if datapoint_pickled is None:
            # the key was scanned at construction — a None get means the
            # record vanished or the page holding it is torn
            raise DataIntegrityError(
                f"{self.db_path}: LMDB get returned None for record "
                f"{idx} (key {self._keys[idx]!r}) — the record is "
                f"missing or its page is corrupt"
            )
        try:
            return pickle.loads(datapoint_pickled)
        except (pickle.UnpicklingError, EOFError, ValueError,
                AttributeError, ImportError, IndexError) as e:
            raise DataIntegrityError(
                f"{self.db_path}: LMDB record {idx} does not unpickle — "
                f"the record is torn: {e}"
            ) from e
