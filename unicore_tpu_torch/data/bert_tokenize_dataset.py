"""WordPiece tokenization wrapper (a copy of
``unicore_tpu/data/bert_tokenize_dataset.py``; reference:
unicore/data/bert_tokenize_dataset.py — uses HuggingFace's
BertWordPieceTokenizer). Gated on the ``tokenizers``/``transformers``
packages; raw-text pipelines that pre-tokenize offline don't need it."""

import numpy as np

from .base_wrapper_dataset import BaseWrapperDataset


class BertTokenizeDataset(BaseWrapperDataset):
    def __init__(self, dataset, dict_path: str, max_seq_len: int = 512):
        super().__init__(dataset)
        self.dict_path = dict_path
        self.max_seq_len = max_seq_len
        self._tokenizer = None

    @property
    def tokenizer(self):
        if self._tokenizer is None:
            try:
                from tokenizers import BertWordPieceTokenizer

                self._tokenizer = BertWordPieceTokenizer(
                    self.dict_path, lowercase=True)
                self._hf_fast = False
            except ImportError:
                from transformers import BertTokenizerFast

                self._tokenizer = BertTokenizerFast(
                    self.dict_path, do_lower_case=True)
                self._hf_fast = True
        return self._tokenizer

    def __getitem__(self, index: int):
        raw_str = self.dataset[index]
        raw_str = raw_str.replace("<unk>", "[UNK]")
        if not hasattr(self, "_hf_fast"):
            self.tokenizer  # force backend selection
        if self._hf_fast:
            ids = self.tokenizer(raw_str,
                                 add_special_tokens=False)["input_ids"]
        else:
            ids = self.tokenizer.encode(raw_str, add_special_tokens=False).ids
        if len(ids) > self.max_seq_len - 2:
            ids = ids[: self.max_seq_len - 2]
        return np.asarray(ids, dtype=np.int64)
