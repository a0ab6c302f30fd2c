"""Data pipeline of the port (numpy; no torch until the trainer moves a
batch to the device): the part of ``unicore_tpu/data`` the tasks reach,
copied with its imports rewritten — record stores (``.rec`` and LMDB),
tokenizers, the masking and padding wrappers, and the epoch iterator
with its worker pools and prefetch pump.  The record store's file
format is the JAX package's, so the two packages read each other's
corpora.
"""

from .unicore_dataset import UnicoreDataset, EpochListening  # noqa isort:skip
from .base_wrapper_dataset import BaseWrapperDataset  # noqa isort:skip

from . import data_utils, iterators, record_reader  # noqa
from .bert_tokenize_dataset import BertTokenizeDataset  # noqa
from .dictionary import Dictionary  # noqa
from .indexed_dataset import (  # noqa
    DataIntegrityError,
    IndexedRecordDataset,
    IndexedRecordWriter,
    best_record_dataset,
)
from .iterators import set_worker_impl, worker_impl  # noqa
from .lmdb_dataset import LMDBDataset  # noqa
from .mask_tokens_dataset import MaskTokensDataset  # noqa
from .misc_datasets import LRUCacheDataset, NumelDataset, NumSamplesDataset  # noqa
from .nested_dictionary_dataset import NestedDictionaryDataset  # noqa
from .packing import PackedTokenDataset, pack_lengths  # noqa
from .resilient import (  # noqa
    DataGuardConfig,
    GuardedDataset,
    SkipLog,
    maybe_guard,
    resample_index,
)
from .pad_dataset import (  # noqa
    LeftPadDataset,
    PadDataset,
    RightPadDataset,
    RightPadDataset2D,
)
from .sort_dataset import EpochShuffleDataset, SortDataset  # noqa
from .token_datasets import (  # noqa
    AppendTokenDataset,
    FromNumpyDataset,
    PrependTokenDataset,
    RawArrayDataset,
    RawLabelDataset,
    RawNumpyDataset,
    TokenizeDataset,
    TruncateDataset,
)
