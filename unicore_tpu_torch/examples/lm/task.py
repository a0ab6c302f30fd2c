"""Causal LM task (counterpart of ``examples/lm/task.py``): next-token
prediction over record stores.

Pipeline: ``.rec`` record store of token lists -> truncate to
``--max-seq-len`` - 1 -> tokenize by the dictionary (LRU-cached: input
and target both read it) -> (input = [bos, t_0..t_{n-1}], target =
[t_0..t_{n-1}, eos]) -> right-pad to ``--max-seq-len`` -> seeded
shuffle; the same datasets, in the same order, as the JAX task, so the
batches are equal.  ``--pack-sequences`` bin-packs the (input, target)
pairs into rows of ``--max-seq-len`` (at most ``--pack-max-segments``
a row) with per-segment ``segment_ids`` and ``positions``
(:class:`~unicore_tpu_torch.data.packing.PackedTokenDataset`), the rows
shuffled under the seed, as the JAX task packs them.
"""

import logging
import os

import numpy as np

from ...data import (AppendTokenDataset, Dictionary, LRUCacheDataset,
                     NestedDictionaryDataset, PrependTokenDataset,
                     RightPadDataset, SortDataset, TokenizeDataset,
                     TruncateDataset, best_record_dataset, data_utils)
from ...data.indexed_dataset import find_split
from ...data.packing import PackedTokenDataset
from ...tasks import UnicoreTask, register_task

logger = logging.getLogger(__name__)


@register_task("lm")
class LMTask(UnicoreTask):
    """Train a causal (left-to-right) language model."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("data",
                            help="directory with {split}.rec and dict.txt")

    def __init__(self, args, dictionary):
        super().__init__(args)
        self.dictionary = dictionary
        self.seed = args.seed

    @classmethod
    def setup_task(cls, args, **kwargs):
        dictionary = Dictionary.load(os.path.join(args.data, "dict.txt"))
        logger.info("dictionary: {} types".format(len(dictionary)))
        return cls(args, dictionary)

    def load_dataset(self, split, combine=False, **kwargs):
        split_path = find_split(self.args.data, split)
        # long lines are clipped to fit bos/eos in the padded length
        tokens = LRUCacheDataset(TokenizeDataset(
            TruncateDataset(best_record_dataset(split_path),
                            self.args.max_seq_len - 1),
            self.dictionary, max_seq_len=self.args.max_seq_len))
        inputs = PrependTokenDataset(tokens, self.dictionary.bos())
        targets = AppendTokenDataset(tokens, self.dictionary.eos())
        if getattr(self.args, "pack_sequences", False):
            # every record's length is read here, at load
            lengths = [len(inputs[i]) for i in range(len(inputs))]
            packed = PackedTokenDataset(
                inputs, targets, lengths, self.args.max_seq_len,
                self.dictionary.pad(),
                max_segments=getattr(self.args, "pack_max_segments", 0))
            logger.info(
                "packed %d samples (%d tokens) into %d rows of %d (pad "
                "waste %.1f%%)", len(lengths), sum(lengths), len(packed),
                self.args.max_seq_len, 100.0 * (1.0 - sum(lengths) / (
                    len(packed) * self.args.max_seq_len)))
            with data_utils.numpy_seed(self.args.seed):
                shuffle = np.random.permutation(len(packed))
            self.datasets[split] = SortDataset(packed, sort_order=[shuffle])
            return
        with data_utils.numpy_seed(self.args.seed):
            shuffle = np.random.permutation(len(tokens))
        pad = self.dictionary.pad()
        self.datasets[split] = SortDataset(
            NestedDictionaryDataset({
                "net_input": {"src_tokens": RightPadDataset(
                    inputs, pad_idx=pad,
                    pad_to_length=self.args.max_seq_len)},
                "target": RightPadDataset(
                    targets, pad_idx=pad,
                    pad_to_length=self.args.max_seq_len),
            }),
            sort_order=[shuffle])
