"""BERT masked-LM task (counterpart of ``examples/bert/task.py``).

Pipeline: record store (``.lmdb`` first, then ``.rec``) -> tokenize
(token lists by the dictionary, raw text by WordPiece over ``dict.txt``)
-> BERT masking twins -> nested dict -> right-pad to ``--max-seq-len``
-> seeded shuffle; the same datasets, in the same order, as the JAX
task.  Records of token-string lists are taken as ``--pre-tokenized``.
"""

import logging
import os

import numpy as np

from ...data import (BertTokenizeDataset, Dictionary, MaskTokensDataset,
                     NestedDictionaryDataset, RightPadDataset, SortDataset,
                     TokenizeDataset, best_record_dataset, data_utils)
from ...data.indexed_dataset import find_split
from ...tasks import UnicoreTask, register_task

logger = logging.getLogger(__name__)


@register_task("bert")
class BertTask(UnicoreTask):
    """Task for training masked language models (e.g., BERT)."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("data", help="path to the data directory")
        parser.add_argument("--mask-prob", default=0.15, type=float,
                            help="probability of replacing a token with mask")
        parser.add_argument("--leave-unmasked-prob", default=0.1, type=float,
                            help="probability that a masked token is "
                                 "unmasked")
        parser.add_argument("--random-token-prob", default=0.1, type=float,
                            help="probability of replacing a token with a "
                                 "random token")
        parser.add_argument("--pre-tokenized", action="store_true",
                            help="records are already token lists")

    def __init__(self, args, dictionary):
        super().__init__(args)
        self.dictionary = dictionary
        self.seed = args.seed
        self.mask_idx = dictionary.add_symbol("[MASK]", is_special=True)

    @classmethod
    def setup_task(cls, args, **kwargs):
        dictionary = Dictionary.load(os.path.join(args.data, "dict.txt"))
        logger.info("dictionary: {} types".format(len(dictionary)))
        return cls(args, dictionary)

    def load_dataset(self, split, combine=False, **kwargs):
        split_path = find_split(self.args.data, split)
        dataset = best_record_dataset(split_path)
        pre_tokenized = getattr(self.args, "pre_tokenized", False)
        if not pre_tokenized and len(dataset):
            first = dataset[0]
            # preprocess.py stores token-string LISTS by default: a
            # sequence of strings is taken as tokenized; anything else
            # (raw text, or ids that should fail loudly) reaches the
            # WordPiece tokenizer
            if (isinstance(first, (list, tuple)) and first
                    and all(isinstance(t, str) for t in first)):
                logger.warning(
                    "%s records are token lists, not raw text — assuming "
                    "--pre-tokenized (pass it explicitly to silence this)",
                    split_path)
                pre_tokenized = True
        if pre_tokenized:
            dataset = TokenizeDataset(dataset, self.dictionary,
                                      max_seq_len=self.args.max_seq_len)
        else:
            dataset = BertTokenizeDataset(
                dataset, os.path.join(self.args.data, "dict.txt"),
                max_seq_len=self.args.max_seq_len)
        src_dataset, tgt_dataset = MaskTokensDataset.apply_mask(
            dataset, self.dictionary, pad_idx=self.dictionary.pad(),
            mask_idx=self.mask_idx, seed=self.args.seed,
            mask_prob=self.args.mask_prob,
            leave_unmasked_prob=self.args.leave_unmasked_prob,
            random_token_prob=self.args.random_token_prob)
        with data_utils.numpy_seed(self.args.seed):
            shuffle = np.random.permutation(len(src_dataset))
        pad = self.dictionary.pad()
        self.datasets[split] = SortDataset(
            NestedDictionaryDataset({
                "net_input": {"src_tokens": RightPadDataset(
                    src_dataset, pad_idx=pad,
                    pad_to_length=self.args.max_seq_len)},
                "target": RightPadDataset(
                    tgt_dataset, pad_idx=pad,
                    pad_to_length=self.args.max_seq_len),
            }),
            sort_order=[shuffle])
