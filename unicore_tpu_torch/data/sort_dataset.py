"""Ordering wrappers (fill the role of ``unicore/data/sort_dataset.py``).

``SortDataset`` imposes a lexicographic order over one or more key arrays
(last key is primary, numpy ``lexsort`` convention); ``EpochShuffleDataset``
draws a fresh deterministic permutation per epoch from a counter-based
Philox generator seeded by (seed, epoch) — no global numpy RNG state is
touched, unlike the reference's ``numpy_seed`` context."""

import numpy as np

from .base_wrapper_dataset import BaseWrapperDataset


class SortDataset(BaseWrapperDataset):
    def __init__(self, dataset, sort_order):
        super().__init__(dataset)
        keys = sort_order if isinstance(sort_order, (list, tuple)) else [sort_order]
        self._keys = tuple(np.asarray(k) for k in keys)
        for k in self._keys:
            if len(k) != len(dataset):
                raise ValueError(
                    f"sort key length {len(k)} != dataset length {len(dataset)}"
                )

    def ordered_indices(self):
        return np.lexsort(self._keys)


class EpochShuffleDataset(BaseWrapperDataset):
    def __init__(self, dataset, size=None, seed=1):
        super().__init__(dataset)
        self._n = len(dataset) if size is None else size
        self._seed = seed
        self.set_epoch(1)

    def set_epoch(self, epoch):
        super().set_epoch(epoch)
        gen = np.random.Generator(np.random.Philox(key=self._seed + epoch - 1))
        self._order = gen.permutation(self._n)

    def ordered_indices(self):
        return self._order

    can_reuse_epoch_itr_across_epochs = False
