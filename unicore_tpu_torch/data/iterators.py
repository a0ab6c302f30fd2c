"""Epoch/batch iteration for the port's training loop (the part of
``unicore_tpu/data/iterators.py`` the BERT path reaches).

Same batch order as the JAX package on one worker: a frozen global batch
list, reshuffled each epoch under ``numpy_seed(seed + epoch)``.  Batches
materialize inline in the training process; data-parallel shards
(ROADMAP.md A8), worker pools, prefetch threads and mid-epoch resume
(A4) are not ported yet.
"""

import itertools

import numpy as np

from . import data_utils


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
        self._active = None

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

    @property
    def next_epoch_idx(self):
        if self._active is not None and not self._active.has_next():
            return self.epoch + 1
        return self.epoch

    def next_epoch_itr(self, shuffle=True):
        self.epoch = self.next_epoch_idx
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.epoch)
        plan = self._plan(self.epoch, shuffle)
        self._active = CountingIterator(map(self._load, plan), start=0,
                                        total=len(plan))
        return self._active

    def end_of_epoch(self):
        return self._active is not None and not self._active.has_next()
