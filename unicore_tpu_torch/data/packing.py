"""Sequence-packing dataset (counterpart of ``unicore_tpu/data/packing.py``;
``--pack-sequences``): bin-pack variable-length samples into fixed [B, T]
rows with per-segment metadata.

Attention in a packed row is segment-causal (no token attends across a
segment boundary: ``modules/multihead_attention.py`` ``_segment_bias``)
and positions reset per segment (the model's ``positions`` operand).
Losses need no packing awareness: pad slots carry ``pad_idx`` targets,
which the token-weighted losses mask.

- :func:`pack_lengths` — deterministic first-fit binning, a pure function
  of (lengths, capacity, max_segments), so every rank, every resume and
  the JAX package compute the same layout.
- :class:`PackedTokenDataset` — one packed row per bin: ``src_tokens`` /
  ``target`` (pad-filled), 1-based ``segment_ids`` (0 = pad) and
  per-segment ``positions`` (-1 = pad), collated into the
  ``{"net_input": ..., "target": ...}`` batch.
"""

import numpy as np

from .unicore_dataset import UnicoreDataset


def pack_lengths(lengths, capacity, max_segments=0):
    """First-fit bin packing of ``lengths`` into bins of ``capacity``.

    Walks samples in the given order and places each into the FIRST open
    bin with room (and segment headroom when ``max_segments`` > 0),
    opening a new bin when none fits.  Deterministic and order-stable: a
    pure function of the inputs.  Over-long samples (length > capacity)
    get a bin of their own and are truncated downstream by the dataset.

    Returns a list of index lists, one per packed row.
    """
    bins = []       # list of [indices]
    room = []       # remaining capacity per bin
    for idx, n in enumerate(lengths):
        n = min(int(n), int(capacity))
        placed = False
        for b in range(len(bins)):
            if room[b] >= n and (
                max_segments <= 0 or len(bins[b]) < max_segments
            ):
                bins[b].append(idx)
                room[b] -= n
                placed = True
                break
        if not placed:
            bins.append([idx])
            room.append(int(capacity) - n)
    return bins


class PackedTokenDataset(UnicoreDataset):
    """Pack an (inputs, targets) token-dataset pair into fixed-length rows.

    ``inputs[i]`` and ``targets[i]`` must be 1-D int arrays of equal
    length (the causal-LM shifted pair).  Each item of this dataset is
    one packed row; ``collater`` stacks rows into the static-shape batch:

    ``{"net_input": {"src_tokens", "segment_ids", "positions"},
       "target"}``
    """

    def __init__(self, inputs, targets, lengths, seq_len, pad_idx,
                 max_segments=0):
        self.inputs = inputs
        self.targets = targets
        self.seq_len = int(seq_len)
        self.pad_idx = int(pad_idx)
        self.bins = pack_lengths(lengths, seq_len, max_segments)

    def __len__(self):
        return len(self.bins)

    def __getitem__(self, index):
        T = self.seq_len
        src = np.full(T, self.pad_idx, dtype=np.int64)
        tgt = np.full(T, self.pad_idx, dtype=np.int64)
        seg = np.zeros(T, dtype=np.int32)
        pos = np.full(T, -1, dtype=np.int32)
        off = 0
        for s, idx in enumerate(self.bins[index], start=1):
            inp = np.asarray(self.inputs[idx])
            out = np.asarray(self.targets[idx])
            n = min(len(inp), T - off)
            src[off:off + n] = inp[:n]
            tgt[off:off + n] = out[:n]
            seg[off:off + n] = s
            pos[off:off + n] = np.arange(n, dtype=np.int32)
            off += n
        return {
            "src_tokens": src, "target": tgt,
            "segment_ids": seg, "positions": pos,
        }

    def num_tokens(self, index):
        return self.seq_len

    def size(self, index):
        return self.seq_len

    def collater(self, samples):
        return {
            "net_input": {
                "src_tokens": np.stack([s["src_tokens"] for s in samples]),
                "segment_ids": np.stack([s["segment_ids"] for s in samples]),
                "positions": np.stack([s["positions"] for s in samples]),
            },
            "target": np.stack([s["target"] for s in samples]),
        }
