"""Token-level wrapper datasets (reference: unicore/data/append_token_dataset.py,
prepend_token_dataset.py, tokenize_dataset.py, from_numpy_dataset.py,
raw_dataset.py)."""

import numpy as np

from .base_wrapper_dataset import BaseWrapperDataset


class AppendTokenDataset(BaseWrapperDataset):
    """Append a token (e.g. [SEP]) to every 1-D sample."""

    def __init__(self, dataset, token=None):
        super().__init__(dataset)
        self.token = token

    def __getitem__(self, idx):
        item = np.asarray(self.dataset[idx])
        if self.token is not None:
            item = np.concatenate([item, np.full((1,), self.token, dtype=item.dtype)])
        return item


class PrependTokenDataset(BaseWrapperDataset):
    """Prepend a token (e.g. [CLS]) to every 1-D sample."""

    def __init__(self, dataset, token=None):
        super().__init__(dataset)
        self.token = token

    def __getitem__(self, idx):
        item = np.asarray(self.dataset[idx])
        if self.token is not None:
            item = np.concatenate([np.full((1,), self.token, dtype=item.dtype), item])
        return item


class TruncateDataset(BaseWrapperDataset):
    """Clip every 1-D sample to its first ``max_len`` items (e.g. so long
    corpus lines fit the model's static sequence budget instead of
    tripping TokenizeDataset's length check)."""

    def __init__(self, dataset, max_len):
        super().__init__(dataset)
        self.max_len = max_len

    def __getitem__(self, idx):
        item = self.dataset[idx]
        return item[: self.max_len]


class TokenizeDataset(BaseWrapperDataset):
    """Map raw string/symbol sequences to int64 ids through a Dictionary."""

    def __init__(self, dataset, dictionary, max_seq_len: int = 512):
        super().__init__(dataset)
        self.dictionary = dictionary
        self.max_seq_len = max_seq_len

    def __getitem__(self, index: int):
        raw_data = self.dataset[index]
        assert len(raw_data) < self.max_seq_len and len(raw_data) > 0
        return self.dictionary.vec_index(raw_data).astype(np.int64)


class FromNumpyDataset(BaseWrapperDataset):
    """Wrap a raw numpy array (first axis = samples)."""

    def __getitem__(self, idx):
        return np.asarray(self.dataset[idx])


class RawLabelDataset(BaseWrapperDataset):
    """Scalar labels collated by stacking."""

    def __init__(self, labels):
        super().__init__(None)
        self.labels = labels

    def __getitem__(self, index):
        return self.labels[index]

    def __len__(self):
        return len(self.labels)

    def collater(self, samples):
        return np.asarray(samples)


class RawArrayDataset(BaseWrapperDataset):
    """Pass-through wrapper that stacks samples at collate time."""

    def __init__(self, dataset):
        super().__init__(dataset)

    def __getitem__(self, index):
        return self.dataset[index]

    def collater(self, samples):
        if hasattr(self.dataset, "collater"):
            try:
                return self.dataset.collater(samples)
            except NotImplementedError:
                pass
        return np.stack([np.asarray(s) for s in samples])


class RawNumpyDataset(BaseWrapperDataset):
    """Like RawArrayDataset but always converts to numpy arrays."""

    def __init__(self, dataset):
        super().__init__(dataset)

    def __getitem__(self, index):
        return np.asarray(self.dataset[index])

    def collater(self, samples):
        return np.stack(samples)
