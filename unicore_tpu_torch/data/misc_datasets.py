"""Small utility wrappers (a copy of ``unicore_tpu/data/misc_datasets.py``;
reference: unicore/data/numel_dataset.py, num_samples_dataset.py,
lru_cache_dataset.py).  The LM task reads each tokenized sample through
:class:`LRUCacheDataset`: its input and target leaves both read it."""

from functools import lru_cache

import numpy as np

from .base_wrapper_dataset import BaseWrapperDataset
from .unicore_dataset import UnicoreDataset


class NumelDataset(BaseWrapperDataset):
    """Per-sample element counts (e.g. number of tokens); collates to either
    a vector (reduce=False) or the batch total (reduce=True)."""

    def __init__(self, dataset, reduce=False):
        super().__init__(dataset)
        self.reduce = reduce

    def __getitem__(self, index):
        item = self.dataset[index]
        return np.asarray(item).size

    def collater(self, samples):
        if self.reduce:
            return int(sum(samples))
        return np.asarray(samples, dtype=np.int64)


class NumSamplesDataset(UnicoreDataset):
    """Constant-1 per sample; collates to the batch size."""

    def __getitem__(self, index):
        return 1

    def __len__(self):
        return 0

    def collater(self, samples):
        return int(sum(samples))


class LRUCacheDataset(BaseWrapperDataset):
    def __init__(self, dataset, token=None):
        super().__init__(dataset)

    @lru_cache(maxsize=16)
    def __getitem__(self, index):
        return self.dataset[index]
