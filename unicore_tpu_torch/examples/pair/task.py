"""Pair-regression task (counterpart of ``examples/pair/task.py``):
records carry square pair features and a per-pair scalar target.

Record schema (see :mod:`.make_data`):
    {"pair":   float32 [N, N, F]  binned noisy pairwise features
     "target": float32 [N, N]     the quantity to regress
     "mask":   float32 [N, N]     1 = valid pair (optional: all valid)}

N is fixed per dataset.  The same datasets, in the same order, as the
JAX task; the record's ``mask`` reaches the loss as ``pair_mask``.
"""

import numpy as np

from ...tasks import register_task
from ..evoformer.task import EvoformerTask, _all_valid_pair, _Field


@register_task("pair")
class PairTask(EvoformerTask):
    """Regress a per-pair scalar from a square pair representation."""

    def fields(self, dataset):
        return {
            "net_input": {"pair": _Field(dataset, "pair")},
            "target": _Field(dataset, "target"),
            "pair_mask": _Field(dataset, "mask", default=_all_valid_pair),
        }

    def input_dims(self):
        """The pair feature bins of the records: the model's input
        width."""
        return int(np.asarray(self.first_record()["pair"]).shape[-1])
