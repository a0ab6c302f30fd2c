"""Evoformer task (counterpart of ``examples/evoformer/task.py``): records
carry an MSA, square pair features and a per-pair scalar target.

Record schema (see :mod:`.make_data`):
    {"msa":       float32 [S, R, A]  one-hot MSA rows
     "pair":      float32 [R, R, F]  binned noisy pairwise features
     "target":    float32 [R, R]     the quantity to regress
     "msa_mask":  float32 [S, R]     1 = valid MSA cell (optional)
     "pair_mask": float32 [R, R]     1 = valid pair (optional)}

S and R are fixed per dataset.  The same datasets, in the same order, as
the JAX task.
"""

import logging

import numpy as np

from ...data import (BaseWrapperDataset, NestedDictionaryDataset,
                     SortDataset, best_record_dataset, data_utils)
from ...data.indexed_dataset import find_split
from ...tasks import UnicoreTask, register_task

logger = logging.getLogger(__name__)


class _Field(BaseWrapperDataset):
    """View one key of a dict-record dataset; collates by stacking."""

    def __init__(self, dataset, key, default=None):
        super().__init__(dataset)
        self.key = key
        self.default = default

    def __getitem__(self, index):
        rec = self.dataset[index]
        if self.key not in rec and self.default is not None:
            return self.default(rec)
        return np.asarray(rec[self.key], dtype=np.float32)

    def collater(self, samples):
        return np.stack([np.asarray(s) for s in samples])


def _all_valid_pair(rec):
    n = np.asarray(rec["target"]).shape[0]
    return np.ones((n, n), dtype=np.float32)


def _all_valid_msa(rec):
    s, r = np.asarray(rec["msa"]).shape[:2]
    return np.ones((s, r), dtype=np.float32)


@register_task("evoformer")
class EvoformerTask(UnicoreTask):
    """Regress a per-pair scalar from an MSA + pair representation."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("data", help="directory with {split}.rec")

    def __init__(self, args):
        super().__init__(args)
        self.seed = args.seed
        self._records = {}

    def _split_path(self, split):
        return find_split(self.args.data, split)

    def load_dataset(self, split, combine=False, **kwargs):
        dataset = best_record_dataset(self._split_path(split))
        self._records[split] = dataset
        with data_utils.numpy_seed(self.args.seed):
            shuffle = np.random.permutation(len(dataset))
        self.datasets[split] = SortDataset(
            NestedDictionaryDataset({
                "net_input": {
                    "msa": _Field(dataset, "msa"),
                    "pair": _Field(dataset, "pair"),
                },
                "target": _Field(dataset, "target"),
                "msa_mask": _Field(dataset, "msa_mask",
                                   default=_all_valid_msa),
                "pair_mask": _Field(dataset, "pair_mask",
                                    default=_all_valid_pair),
            }),
            sort_order=[shuffle])

    def input_dims(self):
        """(MSA alphabet, pair feature bins) of the records — the input
        widths of the model — read from the first training record."""
        split = self.args.train_subset
        records = self._records.get(split)
        if records is None:
            records = best_record_dataset(self._split_path(split))
        rec = records[0]
        return (int(np.asarray(rec["msa"]).shape[-1]),
                int(np.asarray(rec["pair"]).shape[-1]))
