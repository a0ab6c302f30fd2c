"""Masked-LM corruption dataset.

Behavioral parity target: ``unicore/data/mask_tokens_dataset.py`` — BERT
masking with a deterministic per-(seed, epoch, index) RNG, probabilistic
rounding of the mask count, and the classic 80/10/10
mask/keep/random-replace split; consumers get twin views, one with the
corrupted tokens (net input) and one with the original tokens at masked
positions and pad everywhere else (target).

Independent implementation: the reference materializes two separate
wrapper datasets that each replay an identical RNG stream (synchronized
through LRU caches).  Here one planner computes the (input, target) pair
in a single pass and both views project out of the shared cached pair —
half the RNG/masking work and no stream-replay coupling to keep in sync.
"""

from functools import lru_cache

import numpy as np

from . import data_utils
from .base_wrapper_dataset import BaseWrapperDataset


class MaskTokensDataset(BaseWrapperDataset):
    """One view (input or target) of the masked-LM corruption of a dataset.

    Build both views with :meth:`apply_mask`; each indexes the shared
    per-item plan, so the pair is always consistent.
    """

    @classmethod
    def apply_mask(cls, dataset, vocab, *, pad_idx, mask_idx, seed=1,
                   mask_prob=0.15, leave_unmasked_prob=0.1,
                   random_token_prob=0.1):
        """Return ``(input_view, target_view)`` over one shared mask plan."""
        planner = _MaskPlan(
            dataset, vocab, pad_idx=pad_idx, mask_idx=mask_idx, seed=seed,
            mask_prob=mask_prob, leave_unmasked_prob=leave_unmasked_prob,
            random_token_prob=random_token_prob,
        )
        return cls(planner, slot=0), cls(planner, slot=1)

    def __init__(self, planner, slot):
        super().__init__(planner)
        self.slot = slot  # 0 = corrupted input, 1 = target

    def __getitem__(self, index):
        return self.dataset[index][self.slot]

    @property
    def can_reuse_epoch_itr_across_epochs(self):
        return False  # masks are redrawn every epoch


class _MaskPlan(BaseWrapperDataset):
    """Computes (corrupted_input, target) pairs, cached per (epoch, index)."""

    def __init__(self, dataset, vocab, *, pad_idx, mask_idx, seed,
                 mask_prob, leave_unmasked_prob, random_token_prob):
        super().__init__(dataset)
        if not (0.0 < mask_prob < 1.0):
            raise ValueError(f"mask_prob must be in (0, 1), got {mask_prob}")
        keep_or_rand = leave_unmasked_prob + random_token_prob
        if not (0.0 <= leave_unmasked_prob <= 1.0
                and 0.0 <= random_token_prob <= 1.0 and keep_or_rand <= 1.0):
            raise ValueError(
                "leave_unmasked_prob/random_token_prob must be probabilities "
                "summing to at most 1"
            )
        self.vocab = vocab
        self.pad_idx = pad_idx
        self.mask_idx = mask_idx
        self.seed = seed
        self.mask_prob = mask_prob
        self.leave_unmasked_prob = leave_unmasked_prob
        self.random_token_prob = random_token_prob
        self.epoch = None
        # random replacements draw uniformly over non-special symbols
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
        with data_utils.numpy_seed(self.seed, epoch, index):
            # the fetch happens INSIDE the seeded scope: underlying
            # datasets that draw numpy randomness (e.g. conformer sampling
            # in Uni-Mol-style workloads) must stay deterministic per
            # (seed, epoch, index) — reference mask_tokens_dataset.py
            # scopes the access the same way
            item = np.asarray(self.dataset[index])
            if self.mask_idx in item:
                raise ValueError(
                    f"sample {index} already contains mask_idx={self.mask_idx}"
                )
            n = len(item)
            # mask-count rounding is probabilistic so E[count] is exact
            count = int(self.mask_prob * n + np.random.rand())
            chosen = np.zeros(n, dtype=bool)
            chosen[np.random.choice(n, count, replace=False)] = True

            # split the chosen positions into mask / keep / random-replace
            keep_or_rand = self.leave_unmasked_prob + self.random_token_prob
            keep = np.zeros(n, dtype=bool)
            rand = np.zeros(n, dtype=bool)
            if keep_or_rand > 0.0:
                in_tail = chosen & (np.random.rand(n) < keep_or_rand)
                if self.random_token_prob == 0.0:
                    keep = in_tail
                elif self.leave_unmasked_prob == 0.0:
                    rand = in_tail
                else:
                    as_keep = (
                        np.random.rand(n)
                        < self.leave_unmasked_prob / keep_or_rand
                    )
                    keep = in_tail & as_keep
                    rand = in_tail & ~as_keep

            corrupted = item.copy()
            corrupted[chosen & ~keep & ~rand] = self.mask_idx
            n_rand = int(rand.sum())
            if n_rand:
                corrupted[rand] = np.random.choice(
                    len(self.vocab), n_rand, p=self.replacement_probs
                )

        target = np.full(n, self.pad_idx, dtype=item.dtype)
        target[chosen] = item[chosen]
        return corrupted, target
