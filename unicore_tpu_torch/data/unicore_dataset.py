"""Dataset protocol (fills the role of ``unicore/data/unicore_dataset.py``).

Torch-free and numpy-first: a dataset is a map-style container whose
``collater`` builds the padded, static-shape batch dict the jitted step
consumes.  The protocol is deliberately small — everything the iterator
stack and tasks rely on:

    __getitem__ / __len__ / collater           (required)
    num_tokens / size                          (length-based ordering)
    ordered_indices / batch_by_size            (epoch batch construction)
    set_epoch / can_reuse_epoch_itr_across_epochs  (epoch listening)
    supports_prefetch / prefetch / attr        (optional accelerators)
"""

import numpy as np


class EpochListening:
    """Epoch-awareness half of the protocol: anything that wants the epoch
    number (per-epoch masking, shuffling, curriculum) implements
    ``set_epoch``; iterators check ``can_reuse_epoch_itr_across_epochs``
    before caching a batch order across epochs."""

    can_reuse_epoch_itr_across_epochs = False

    def set_epoch(self, epoch):
        pass


class UnicoreDataset(EpochListening):
    """Map-style dataset with batching helpers."""

    # -- required surface ------------------------------------------------

    def __getitem__(self, index):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def collater(self, samples):
        """Merge a list of samples into the mini-batch dict fed to the
        jitted step."""
        raise NotImplementedError

    # -- sizing (length-based ordering / filtering) -----------------------

    def num_tokens(self, index):
        raise NotImplementedError

    def size(self, index):
        raise NotImplementedError

    # -- epoch batch construction -----------------------------------------

    def ordered_indices(self):
        """Index order batches are drawn in (identity by default)."""
        return np.arange(len(self), dtype=np.int64)

    def batch_by_size(self, indices, batch_size=None,
                      required_batch_size_multiple=1):
        """Chunk ordered indices into fixed-size batches (delegates to
        ``data_utils.batch_by_size`` — fixed batch size, rounded to the
        multiple TPU static shapes want)."""
        from . import data_utils

        return data_utils.batch_by_size(
            indices, batch_size=batch_size,
            required_batch_size_multiple=required_batch_size_multiple,
        )

    def filter_indices_by_size(self, indices, max_sizes):
        """Drop indices whose ``size`` exceeds ``max_sizes`` (scalar or
        per-dimension); returns (kept, ignored_list)."""
        if max_sizes is None:
            return indices, []
        sizes = np.array([self.size(i) for i in indices])
        if isinstance(max_sizes, (int, float)):
            keep = sizes <= max_sizes
        else:
            keep = np.all(sizes <= np.asarray(max_sizes), axis=-1)
        return indices[keep], indices[~keep].tolist()

    # -- optional accelerators ---------------------------------------------

    supports_prefetch = False

    def prefetch(self, indices):
        raise NotImplementedError

    @property
    def prefetch_target(self):
        """Identity of the object whose ``prefetch`` actually runs —
        wrapper stacks forward this to their leaf store, so fan-out
        callers (``NestedDictionaryDataset.prefetch``) can drop duplicate
        calls that bottom out at the same store."""
        return self

    def attr(self, attr, index):
        """Per-sample attribute lookup; defaults to a dataset-level attr."""
        return getattr(self, attr, None)
