"""Collation + batching helpers (reference: unicore/data/data_utils.py).

TPU note: ``collate_tokens`` pads to a multiple of ``pad_to_multiple`` like
the reference (hardwired 8 there); for static-shape-friendly training pass
``pad_to_length`` (e.g. the model's max_seq_len) so every batch compiles to
the same program.
"""

import contextlib
import logging
import threading

import numpy as np

logger = logging.getLogger(__name__)


def collate_tokens(
    values,
    pad_idx,
    left_pad=False,
    pad_to_length=None,
    pad_to_multiple=1,
):
    """Convert a list of 1d numpy arrays into a padded 2d array."""
    values = [np.asarray(v) for v in values]
    size = max(v.shape[0] for v in values)
    size = size if pad_to_length is None else max(size, pad_to_length)
    if pad_to_multiple != 1 and size % pad_to_multiple != 0:
        size = int(((size - 0.1) // pad_to_multiple + 1) * pad_to_multiple)
    res = np.full((len(values), size), pad_idx, dtype=values[0].dtype)
    for i, v in enumerate(values):
        if left_pad:
            res[i, size - len(v):] = v
        else:
            res[i, : len(v)] = v
    return res


def collate_tokens_2d(
    values,
    pad_idx,
    left_pad=False,
    pad_to_length=None,
    pad_to_multiple=1,
):
    """Convert a list of square 2d arrays (pair features) into a padded 3d
    array (reference data_utils.py:56 — used by Uni-Mol/Uni-Fold)."""
    values = [np.asarray(v) for v in values]
    size = max(v.shape[0] for v in values)
    size = size if pad_to_length is None else max(size, pad_to_length)
    if pad_to_multiple != 1 and size % pad_to_multiple != 0:
        size = int(((size - 0.1) // pad_to_multiple + 1) * pad_to_multiple)
    res = np.full((len(values), size, size) + values[0].shape[2:], pad_idx, dtype=values[0].dtype)
    for i, v in enumerate(values):
        n = v.shape[0]
        if left_pad:
            res[i, size - n:, size - n:] = v
        else:
            res[i, :n, :n] = v
    return res


def collate_dict(values, dim=0):
    """Stack a list of dicts of arrays along a new batch dim."""
    if len(values) == 0:
        return {}
    return {
        key: np.stack([v[key] for v in values], axis=dim) for key in values[0].keys()
    }


# numpy's global RNG is one state per process: a scope that seeds it
# must not interleave with another thread's draws (data-worker threads
# each open scopes), so every scope holds this lock
_GLOBAL_RNG_LOCK = threading.RLock()


def _scope_seed(seed, addl_seeds):
    if len(addl_seeds) > 0:
        return int(hash((seed, *addl_seeds)) % 1e6)
    return seed


@contextlib.contextmanager
def numpy_seed(seed, *addl_seeds):
    """Context manager which seeds the numpy PRNG with the specified seed and
    restores the state afterward.  The global state is process-wide, so
    the scope holds a lock: scopes on different threads run one at a
    time (a draw site that needs no global state takes
    :func:`seeded_rng` instead and runs in parallel)."""
    if seed is None:
        yield
        return
    seed = _scope_seed(seed, addl_seeds)
    with _GLOBAL_RNG_LOCK:
        state = np.random.get_state()
        np.random.seed(seed)
        try:
            yield
        finally:
            np.random.set_state(state)


def seeded_rng(seed, *addl_seeds):
    """A private ``np.random.RandomState`` whose draws are exactly those
    that ``np.random`` makes inside ``numpy_seed(seed, *addl_seeds)``
    (the same seed, the same MT19937 stream), without touching the
    global state: thread workers draw from their own."""
    return np.random.RandomState(_scope_seed(seed, addl_seeds))


def batch_by_size(
    indices,
    batch_size=None,
    required_batch_size_multiple=1,
):
    """Chunk ordered *indices* into batches of ``batch_size``, rounding the
    batch size up to a multiple of ``required_batch_size_multiple``
    (reference data_utils.py:107-139 — fixed-count batching, no token-based
    batching; already the TPU-friendly design)."""
    batch_size = batch_size if batch_size is not None else 1
    bsz_mult = required_batch_size_multiple
    if batch_size % bsz_mult != 0:
        batch_size = int(((batch_size - 0.1) // bsz_mult + 1) * bsz_mult)

    indices = np.asarray(indices, dtype=np.int64)
    num_batches = (len(indices) + batch_size - 1) // batch_size
    return [
        indices[i * batch_size : (i + 1) * batch_size] for i in range(num_batches)
    ]


def str_hash(text: str) -> int:
    """Deterministic string hash (python's builtin hash is salted per run)."""
    h = 0
    for ch in text:
        h = (h * 281 ^ ord(ch) * 997) & 0xFFFFFFFF
    return h
