"""Write a synthetic corpus for the ``lm`` task::

    python -m unicore_tpu_torch.examples.lm.make_data -o OUT_DIR \\
        [--train 2048] [--valid 64] [--words 30518] [--min-len 128] \\
        [--max-len 510] [--seed 2048]

Records are token lists (``w0``, ``w1``, ...) drawn from a Zipf(1.1) law
over ``--words`` words, each of ``--min-len`` to ``--max-len`` tokens, written
as ``train.rec`` / ``valid.rec`` ``IndexedRecordWriter`` stores (the JAX
package's record format: either package reads them).  ``dict.txt``
lists the words by descending count rank, so with the dictionary's four
specials the vocabulary is ``--words + 4`` (30,522 by default, BERT's).
The task truncates a record to ``--max-seq-len`` - 1 tokens.
"""

import argparse
import os

import numpy as np

from ...data import IndexedRecordWriter

ZIPF = 1.1  # the exponent of the word-frequency law


def write_corpus(out_dir, train=2048, valid=64, words=30518, min_len=128,
                 max_len=510, seed=2048):
    """``dict.txt``, ``train.rec`` and ``valid.rec`` under ``out_dir``,
    drawn in that order from ``numpy.random.default_rng(seed)``; returns
    the number of tokens written."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = [f"w{i}" for i in range(words)]
    with open(os.path.join(out_dir, "dict.txt"), "w") as f:
        f.writelines(f"{w} {words - i}\n" for i, w in enumerate(names))
    p = np.arange(1, words + 1, dtype=np.float64) ** -ZIPF
    p /= p.sum()
    total = 0
    for split, n in (("train", train), ("valid", valid)):
        lengths = rng.integers(min_len, max_len + 1, size=n)
        ids = rng.choice(words, size=int(lengths.sum()), p=p)
        with IndexedRecordWriter(os.path.join(out_dir, f"{split}.rec")) as w:
            start = 0
            for n_tok in lengths:
                w.write([names[i] for i in ids[start:start + n_tok]])
                start += n_tok
        total += int(lengths.sum())
    return total


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--out-dir", default=".")
    p.add_argument("--train", type=int, default=2048, help="train records")
    p.add_argument("--valid", type=int, default=64, help="valid records")
    p.add_argument("--words", type=int, default=30518,
                   help="words in dict.txt (the vocabulary less 4)")
    p.add_argument("--min-len", type=int, default=128)
    p.add_argument("--max-len", type=int, default=510)
    p.add_argument("--seed", type=int, default=2048)
    a = p.parse_args()
    n = write_corpus(a.out_dir, a.train, a.valid, a.words, a.min_len,
                     a.max_len, a.seed)
    print(f"{a.train} train and {a.valid} valid records, {n} tokens, "
          f"{a.words} words -> {a.out_dir}")


if __name__ == "__main__":
    main()
