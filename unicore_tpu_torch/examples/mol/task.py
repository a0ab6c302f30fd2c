"""Uni-Mol pretraining task (counterpart of ``examples/mol/task.py``):
atom tokens and a 3-D conformer in, three self-supervised targets out —
masked-atom recovery, coordinate denoising and pair-distance recovery.
The clean pair-distance target rides :class:`RightPadDataset2D` into the
batch.

Record schema (see :mod:`.make_data`):
    {"atoms": [str, ...], "coord": float32 [n, 3]}

Corruption is ONE seeded pass per (seed, epoch, index): about
``--mask-prob`` of the atoms are chosen; their tokens get [MASK] / kept /
a random element under ``--leave-unmasked-prob`` and
``--random-token-prob``, and the same atoms move by uniform noise of
``--coord-noise`` Angstroms.  Every view projects out of one cached plan,
so token masking and coordinate noise never drift apart.  The same
datasets, in the same order, with the same draws, as the JAX task.
"""

import logging
import os
from functools import lru_cache

import numpy as np

from ...data import (BaseWrapperDataset, Dictionary, NestedDictionaryDataset,
                     RightPadDataset, RightPadDataset2D, SortDataset,
                     best_record_dataset, data_utils)
from ...tasks import UnicoreTask, register_task

logger = logging.getLogger(__name__)


class MolCorruptDataset(BaseWrapperDataset):
    """One view of the joint token-mask + coordinate-noise corruption."""

    KEYS = ("src_tokens", "tgt_tokens", "src_coord", "tgt_coord", "tgt_dist")

    @classmethod
    def apply(cls, dataset, vocab, *, mask_idx, seed, mask_prob,
              leave_unmasked_prob, random_token_prob, coord_noise):
        planner = _MolPlan(
            dataset, vocab, mask_idx=mask_idx, seed=seed,
            mask_prob=mask_prob, leave_unmasked_prob=leave_unmasked_prob,
            random_token_prob=random_token_prob, coord_noise=coord_noise)
        return {key: cls(planner, key) for key in cls.KEYS}

    def __init__(self, planner, key):
        super().__init__(planner)
        self.key = key

    def __getitem__(self, index):
        return self.dataset[index][self.key]

    @property
    def can_reuse_epoch_itr_across_epochs(self):
        return False  # corruption is redrawn every epoch


class _MolPlan(BaseWrapperDataset):
    """The full corruption plan, cached per (epoch, index)."""

    def __init__(self, dataset, vocab, *, mask_idx, seed, mask_prob,
                 leave_unmasked_prob, random_token_prob, coord_noise):
        super().__init__(dataset)
        self.vocab = vocab
        self.mask_idx = mask_idx
        self.seed = seed
        self.mask_prob = mask_prob
        self.leave_unmasked_prob = leave_unmasked_prob
        self.random_token_prob = random_token_prob
        self.coord_noise = coord_noise
        self.epoch = None
        w = np.ones(len(vocab))
        w[vocab.special_index()] = 0.0
        self.replacement_probs = w / w.sum()

    def set_epoch(self, epoch):
        super().set_epoch(epoch)
        self.epoch = epoch

    @property
    def can_reuse_epoch_itr_across_epochs(self):
        return False

    def __getitem__(self, index):
        return self._plan(self.epoch, index)

    @lru_cache(maxsize=16)
    def _plan(self, epoch, index):
        rec = self.dataset[index]
        tokens = np.asarray([self.vocab.index(sym) for sym in rec["atoms"]],
                            dtype=np.int64)
        coord = np.asarray(rec["coord"], dtype=np.float32)
        n = len(tokens)
        with data_utils.numpy_seed(self.seed, epoch, index):
            count = int(self.mask_prob * n + np.random.rand())
            chosen = np.zeros(n, dtype=bool)
            chosen[np.random.choice(n, count, replace=False)] = True

            corrupted = tokens.copy()
            u = np.random.rand(n)
            masked = chosen & (u >= self.leave_unmasked_prob
                               + self.random_token_prob)
            rand = chosen & (u < self.random_token_prob)
            corrupted[masked] = self.mask_idx
            n_rand = int(rand.sum())
            if n_rand:
                corrupted[rand] = np.random.choice(
                    len(self.vocab), n_rand, p=self.replacement_probs)

            # the chosen atoms move by uniform noise; the model places
            # them back
            noisy = coord.copy()
            noisy[chosen] += np.random.uniform(
                -self.coord_noise, self.coord_noise,
                size=(int(chosen.sum()), 3)).astype(np.float32)

        target = np.full(n, self.vocab.pad(), dtype=tokens.dtype)
        target[chosen] = tokens[chosen]
        dist = np.linalg.norm(coord[:, None, :] - coord[None, :, :],
                              axis=-1).astype(np.float32)
        return {"src_tokens": corrupted, "tgt_tokens": target,
                "src_coord": noisy, "tgt_coord": coord, "tgt_dist": dist}


class PadCoordDataset(BaseWrapperDataset):
    """Pad ``[n, 3]`` coordinates along the atom dim and stack, by the
    size rule of ``collate_tokens`` (``pad_to_length``, then up to a
    multiple of 8), so every leaf of a batch agrees on N."""

    def __init__(self, dataset, pad_to_length, pad_to_multiple=8):
        super().__init__(dataset)
        self.pad_to_length = pad_to_length
        self.pad_to_multiple = pad_to_multiple

    def collater(self, samples):
        size = max(self.pad_to_length, max(len(s) for s in samples))
        m = self.pad_to_multiple
        size = ((size + m - 1) // m) * m
        out = np.zeros((len(samples), size, 3), dtype=np.float32)
        for i, s in enumerate(samples):
            out[i, :len(s)] = s
        return out


@register_task("mol")
class MolTask(UnicoreTask):
    """Masked-atom + coordinate-denoising pretraining on conformers."""

    @staticmethod
    def add_args(parser):
        parser.add_argument("data", help="directory with {split}.rec + "
                                         "dict.txt")
        parser.add_argument("--mask-prob", default=0.15, type=float,
                            help="fraction of atoms corrupted per molecule")
        parser.add_argument("--leave-unmasked-prob", default=0.05,
                            type=float,
                            help="chosen atoms that keep their token")
        parser.add_argument("--random-token-prob", default=0.05, type=float,
                            help="chosen atoms that get a random element")
        parser.add_argument("--coord-noise", default=1.0, type=float,
                            help="uniform coordinate noise amplitude (A) "
                                 "applied to chosen atoms")
        parser.add_argument("--max-atoms", default=32, type=int,
                            help="static per-molecule atom capacity (the "
                                 "batches' padded width)")

    def __init__(self, args, dictionary):
        super().__init__(args)
        self.dictionary = dictionary
        self.seed = args.seed
        self.mask_idx = dictionary.add_symbol("[MASK]", is_special=True)

    @classmethod
    def setup_task(cls, args, **kwargs):
        dictionary = Dictionary.load(os.path.join(args.data, "dict.txt"))
        logger.info("dictionary: {} element types".format(len(dictionary)))
        return cls(args, dictionary)

    def load_dataset(self, split, combine=False, **kwargs):
        split_path = os.path.join(self.args.data, split)
        if os.path.exists(split_path + ".rec"):
            split_path += ".rec"
        views = MolCorruptDataset.apply(
            best_record_dataset(split_path), self.dictionary,
            mask_idx=self.mask_idx, seed=self.args.seed,
            mask_prob=self.args.mask_prob,
            leave_unmasked_prob=self.args.leave_unmasked_prob,
            random_token_prob=self.args.random_token_prob,
            coord_noise=self.args.coord_noise)
        pad = self.dictionary.pad()
        cap = self.args.max_atoms
        with data_utils.numpy_seed(self.args.seed):
            shuffle = np.random.permutation(len(views["src_tokens"]))
        self.datasets[split] = SortDataset(
            NestedDictionaryDataset({
                "net_input": {
                    "src_tokens": RightPadDataset(
                        views["src_tokens"], pad_idx=pad,
                        pad_to_length=cap),
                    "src_coord": PadCoordDataset(views["src_coord"],
                                                 pad_to_length=cap),
                },
                "target": RightPadDataset(views["tgt_tokens"], pad_idx=pad,
                                          pad_to_length=cap),
                "tgt_coord": PadCoordDataset(views["tgt_coord"],
                                             pad_to_length=cap),
                "tgt_dist": RightPadDataset2D(views["tgt_dist"], pad_idx=0.0,
                                              pad_to_length=cap),
            }),
            sort_order=[shuffle])
