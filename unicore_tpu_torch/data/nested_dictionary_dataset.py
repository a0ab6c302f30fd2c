"""Composite dataset over a nested dict of leaf datasets.

Behavioral parity target: ``unicore/data/nested_dictionary_dataset.py`` —
a task declares its batch schema as a nested dict (possibly containing
lists) of datasets, each leaf collates itself with its own ``collater``,
and the collated batch comes back in the same nested shape
(e.g. ``{"net_input": {"src_tokens": ...}, "target": ...}``).

Independent implementation: the schema is walked once into a list of
``(path, dataset)`` pairs, where ``path`` is a tuple of dict keys / list
indices, and batches are assembled by direct path insertion — no dotted
string keys, no unflatten parser.
"""

import numpy as np

from .unicore_dataset import UnicoreDataset


def _walk_leaves(node, path=()):
    """Yield (path_tuple, leaf) for every non-dict/list leaf, depth-first."""
    if isinstance(node, dict):
        for k, v in node.items():
            if v is not None:
                yield from _walk_leaves(v, path + (k,))
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            yield from _walk_leaves(v, path + (i,))
    else:
        yield path, node


def _insert(tree, path, value):
    """Set ``tree[path[0]][path[1]]... = value``, growing dicts/lists."""
    for depth, key in enumerate(path[:-1]):
        nxt_is_list = isinstance(path[depth + 1], int)
        if isinstance(key, int):
            while len(tree) <= key:
                tree.append([] if nxt_is_list else {})
            tree = tree[key]
        else:
            if key not in tree:
                tree[key] = [] if nxt_is_list else {}
            tree = tree[key]
    last = path[-1]
    if isinstance(last, int):
        while len(tree) <= last:
            tree.append(None)
        tree[last] = value
    else:
        tree[last] = value


class NestedDictionaryDataset(UnicoreDataset):
    """Zips equal-length leaf datasets into nested-dict samples."""

    def __init__(self, defn):
        super().__init__()
        self.leaves = list(_walk_leaves(defn))
        if not self.leaves:
            raise ValueError("empty dataset definition")
        lengths = set()
        for path, ds in self.leaves:
            if not isinstance(ds, UnicoreDataset):
                raise ValueError(
                    f"leaf {'.'.join(map(str, path))} is a "
                    f"{type(ds).__name__}, expected a UnicoreDataset"
                )
            if len(ds) > 0:
                lengths.add(len(ds))
        if len(lengths) > 1:
            raise ValueError(f"leaf dataset lengths differ: {sorted(lengths)}")
        self._len = lengths.pop() if lengths else 0

    def __len__(self):
        return self._len

    def __getitem__(self, index):
        # samples stay in leaf-list form until collation; only the collated
        # batch is materialized as a nested dict
        return [ds[index] for _, ds in self.leaves]

    def collater(self, samples):
        if len(samples) == 0:
            return {}
        batch = {}
        for slot, (path, ds) in enumerate(self.leaves):
            column = [s[slot] for s in samples]
            try:
                merged = ds.collater(column)
            except NotImplementedError:
                merged = np.stack([np.asarray(x) for x in column])
            _insert(batch, path, merged)
        return batch

    # size accounting: a row is as big as its biggest leaf ---------------

    def num_tokens(self, index):
        return max(ds.num_tokens(index) for _, ds in self.leaves)

    def size(self, index):
        return max(ds.size(index) for _, ds in self.leaves)

    # epoch / prefetch fan-out -------------------------------------------

    def set_epoch(self, epoch):
        super().set_epoch(epoch)
        for _, ds in self.leaves:
            ds.set_epoch(epoch)

    @property
    def can_reuse_epoch_itr_across_epochs(self):
        return all(ds.can_reuse_epoch_itr_across_epochs for _, ds in self.leaves)

    @property
    def supports_prefetch(self):
        return any(getattr(ds, "supports_prefetch", False) for _, ds in self.leaves)

    def prefetch(self, indices):
        # dedupe by the LEAF STORE actually performing the prefetch:
        # several leaves (e.g. the mask-tokens src/tgt twins) bottom out
        # at one record store, and re-reading the same spans would double
        # the readahead IO.  Per-call local state — unlike a cross-call
        # "last indices" key on the store itself, this cannot be defeated
        # by concurrent worker threads interleaving different batches.
        seen = set()
        for _, ds in self.leaves:
            if not getattr(ds, "supports_prefetch", False):
                continue
            target = id(getattr(ds, "prefetch_target", ds))
            if target in seen:
                continue
            seen.add(target)
            ds.prefetch(indices)
