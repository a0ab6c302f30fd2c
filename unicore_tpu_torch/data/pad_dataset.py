"""Padding collate wrappers (reference: unicore/data/pad_dataset.py).

The reference hardwires ``pad_to_multiple=8``; here it is a constructor knob
defaulting to 8, plus an optional ``pad_to_length`` giving fully static
shapes (one compiled program for every batch — the TPU-preferred mode).
"""

from . import data_utils
from .base_wrapper_dataset import BaseWrapperDataset


class PadDataset(BaseWrapperDataset):
    def __init__(self, dataset, pad_idx, left_pad, pad_to_length=None, pad_to_multiple=8):
        super().__init__(dataset)
        self.pad_idx = pad_idx
        self.left_pad = left_pad
        self.pad_to_length = pad_to_length
        self.pad_to_multiple = pad_to_multiple

    def collater(self, samples):
        return data_utils.collate_tokens(
            samples,
            self.pad_idx,
            left_pad=self.left_pad,
            pad_to_length=self.pad_to_length,
            pad_to_multiple=self.pad_to_multiple,
        )


class LeftPadDataset(PadDataset):
    def __init__(self, dataset, pad_idx, pad_to_length=None, pad_to_multiple=8):
        super().__init__(
            dataset, pad_idx, left_pad=True,
            pad_to_length=pad_to_length, pad_to_multiple=pad_to_multiple,
        )


class RightPadDataset(PadDataset):
    def __init__(self, dataset, pad_idx, pad_to_length=None, pad_to_multiple=8):
        super().__init__(
            dataset, pad_idx, left_pad=False,
            pad_to_length=pad_to_length, pad_to_multiple=pad_to_multiple,
        )


class RightPadDataset2D(BaseWrapperDataset):
    """Pads square 2-D pair features (Uni-Mol/Uni-Fold)."""

    def __init__(self, dataset, pad_idx, left_pad=False, pad_to_length=None, pad_to_multiple=8):
        super().__init__(dataset)
        self.pad_idx = pad_idx
        self.left_pad = left_pad
        self.pad_to_length = pad_to_length
        self.pad_to_multiple = pad_to_multiple

    def collater(self, samples):
        return data_utils.collate_tokens_2d(
            samples,
            self.pad_idx,
            left_pad=self.left_pad,
            pad_to_length=self.pad_to_length,
            pad_to_multiple=self.pad_to_multiple,
        )
