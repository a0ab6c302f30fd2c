"""Transparent wrapper base (fills the role of
``unicore/data/base_wrapper_dataset.py``).

Instead of hand-writing one forwarding method per protocol member, the
delegating methods are generated from the protocol surface below —
subclasses override just the members they change, and any protocol
addition only needs its name added to one tuple.
"""

from .unicore_dataset import UnicoreDataset


def _forward(name):
    def method(self, *args, **kwargs):
        return getattr(self.dataset, name)(*args, **kwargs)

    method.__name__ = name
    method.__qualname__ = f"BaseWrapperDataset.{name}"
    method.__doc__ = f"Forward ``{name}`` to the wrapped dataset."
    return method


class BaseWrapperDataset(UnicoreDataset):
    def __init__(self, dataset):
        super().__init__()
        self.dataset = dataset

    def __getitem__(self, index):
        return self.dataset[index]

    def __len__(self):
        return len(self.dataset)

    def set_epoch(self, epoch):
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    @property
    def supports_prefetch(self):
        return getattr(self.dataset, "supports_prefetch", False)

    @property
    def prefetch_target(self):
        # a subclass that overrides prefetch() (e.g. with index remapping)
        # is its own dedup identity: forwarding to the wrapped target would
        # let NestedDictionaryDataset's id()-based dedup silently skip the
        # override
        if type(self).prefetch is not BaseWrapperDataset.prefetch:
            return self
        return getattr(self.dataset, "prefetch_target", self.dataset)

    @property
    def can_reuse_epoch_itr_across_epochs(self):
        return self.dataset.can_reuse_epoch_itr_across_epochs


for _name in ("collater", "num_tokens", "size", "ordered_indices",
              "prefetch", "attr"):
    setattr(BaseWrapperDataset, _name, _forward(_name))
del _name
