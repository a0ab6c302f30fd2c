"""Epoch/batch iteration for the port's training loop (the part of
``unicore_tpu/data/iterators.py`` the BERT path reaches).

Same batch order as the JAX package on one worker: a frozen global batch
list, reshuffled each epoch under ``numpy_seed(seed + epoch)``.  The
position rides checkpoints in the reference's version-2 dict
(:meth:`EpochBatchIterator.state_dict`), and a restored iterator opens
its epoch at the saved offset.  Batches materialize inline in the
training process; data-parallel shards (ROADMAP.md A8), worker pools and
prefetch threads (A4) are not ported yet.
"""

import itertools
import logging

import numpy as np

from . import data_utils

logger = logging.getLogger(__name__)


class CountingIterator:
    """Iterator wrapper tracking an absolute position ``n`` (``total`` is
    the absolute end)."""

    def __init__(self, iterable, start=None, total=None):
        self._source = iter(iterable)
        self.n = start if start is not None else getattr(iterable, "n", 0)
        self.total = total if total is not None else self.n + len(iterable)

    def __len__(self):
        return self.total

    def __iter__(self):
        return self

    def __next__(self):
        if self.n >= self.total:
            raise StopIteration
        try:
            value = next(self._source)
        except StopIteration:
            self.total = self.n
            raise
        self.n += 1
        return value

    def has_next(self):
        return self.n < self.total


class GroupedIterator(CountingIterator):
    """Yields lists of up to ``chunk_size`` items — the grad-accumulation
    micro-batch groups of one ``Trainer.train_step``."""

    def __init__(self, iterable, chunk_size):
        def chunks():
            source = iter(iterable)
            while True:
                group = list(itertools.islice(source, chunk_size))
                if not group:
                    return
                yield group

        super().__init__(chunks(),
                         start=-(-getattr(iterable, "n", 0) // chunk_size),
                         total=-(-len(iterable) // chunk_size))


class EpochBatchIterator:
    """Multi-epoch iterator over a frozen batch list."""

    def __init__(self, dataset, collate_fn, batch_sampler, seed=1, epoch=1):
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.frozen_batches = tuple(batch_sampler)
        self.seed = seed
        self.epoch = max(epoch, 1)
        self.shuffle = True
        self._active = None
        self._resumed = None

    def __len__(self):
        return len(self.frozen_batches)

    def _load(self, indices):
        return self.collate_fn([self.dataset[int(i)] for i in indices])

    def _plan(self, epoch, shuffle):
        batches = list(self.frozen_batches)
        if shuffle:
            with data_utils.numpy_seed(self.seed + epoch):
                order = np.random.permutation(len(batches))
            batches = [batches[i] for i in order]
        return batches

    def _open_stream(self, epoch, shuffle, offset=0):
        """The epoch's batches from ``offset`` on; None when the offset is
        past the end."""
        plan = self._plan(epoch, shuffle)
        if offset > 0 and offset >= len(plan):
            return None
        return CountingIterator(map(self._load, plan[offset:]),
                                start=offset, total=len(plan))

    @property
    def iterations_in_epoch(self):
        stream = self._active or self._resumed
        return 0 if stream is None else stream.n

    @property
    def next_epoch_idx(self):
        if self._resumed is not None:
            return self.epoch
        if self._active is not None and not self._active.has_next():
            return self.epoch + 1
        return self.epoch

    def next_epoch_itr(self, shuffle=True):
        self.epoch = self.next_epoch_idx
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        if self._resumed is not None:
            self._active, self._resumed = self._resumed, None
        else:
            self._active = self._open_stream(self.epoch, shuffle)
            self.shuffle = shuffle
        return self._active

    def end_of_epoch(self):
        return self._active is not None and not self._active.has_next()

    # -- checkpoint state (the reference's version 2) -------------------

    def state_dict(self):
        if self.end_of_epoch():
            epoch, position = self.epoch + 1, 0
        else:
            epoch, position = self.epoch, self.iterations_in_epoch
        return {"version": 2, "epoch": epoch, "iterations_in_epoch": position,
                "shuffle": self.shuffle, "len": len(self)}

    def load_state_dict(self, state_dict):
        self.epoch = state_dict["epoch"]
        position = state_dict.get("iterations_in_epoch", 0)
        saved_len = state_dict.get("len")
        if saved_len not in (None, len(self)) and position > 0:
            # the epoch's length changed between runs (batching changed):
            # keep the same fraction of the epoch consumed
            rescaled = int(round(position * len(self) / float(saved_len)))
            logger.info("epoch length changed (%d -> %d); resume position "
                        "%d -> %d", saved_len, len(self), position, rescaled)
            position = rescaled
        if position > 0:
            if hasattr(self.dataset, "set_epoch"):
                self.dataset.set_epoch(self.epoch)
            self.shuffle = state_dict.get("shuffle", True)
            self._resumed = self._open_stream(self.epoch, self.shuffle,
                                              offset=position)
            if self._resumed is None:
                if state_dict.get("version", 1) == 1:
                    self.epoch += 1  # legacy: the epoch ended at the save
                else:
                    raise RuntimeError(
                        "cannot resume: saved position is past the end of "
                        "the epoch; relaunch with --reset-dataloader")
        else:
            self._resumed = None
