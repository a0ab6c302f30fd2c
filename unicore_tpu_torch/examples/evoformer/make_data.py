"""Write a synthetic MSA + pair corpus for the Evoformer example (a copy
of ``examples/evoformer/example_data/make_data.py``; for one
``RandomState`` it gives the same records)::

    python -m unicore_tpu_torch.examples.evoformer.make_data -o OUT_DIR \\
        [--n-res 16] [--n-seqs 8] [--alphabet 8] [--bins 8] [--train 256] \\
        [--valid 32] [--noise 1.0] [--seed 7]

Each sample is a random 3-D point cloud of R residues; the target is its
distance matrix.  ``pair`` is a one-hot binning of a noisy distance;
``msa`` holds S rows over an alphabet of A tokens with correlated
mutations at contacting pairs (the covariation the outer product mean
extracts).  A random suffix of MSA rows is masked out per sample.
"""

import argparse
import os

import numpy as np

from ...data import IndexedRecordWriter


def make_sample(rng, n_res, n_seqs, alphabet, bins, noise):
    xyz = rng.randn(n_res, 3).astype(np.float32) * 2.0
    diff = xyz[:, None, :] - xyz[None, :, :]
    dist = np.sqrt((diff ** 2).sum(-1)).astype(np.float32)  # [R, R]

    # noisy binned pair features
    noisy = dist + rng.randn(n_res, n_res).astype(np.float32) * noise
    noisy = np.maximum(0.5 * (noisy + noisy.T), 0.0)
    hi = np.percentile(dist, 97)
    edges = np.linspace(hi / (bins - 1), hi, bins - 1)
    feat = np.eye(bins, dtype=np.float32)[np.digitize(noisy, edges)]

    # contacts: the closest non-self pairs
    contact = dist < np.percentile(dist + np.eye(n_res) * 1e9, 25)
    partners = [np.flatnonzero(contact[i]) for i in range(n_res)]

    base = rng.randint(0, alphabet, size=n_res)
    msa_tok = np.tile(base, (n_seqs, 1))
    for s in range(1, n_seqs):
        mutate = rng.rand(n_res) < 0.3
        offset = rng.randint(1, alphabet, size=n_res)
        for i in np.flatnonzero(mutate):
            msa_tok[s, i] = (base[i] + offset[i]) % alphabet
            for j in partners[i]:
                # correlated co-mutation at contacts
                msa_tok[s, j] = (base[j] + offset[i]) % alphabet
    msa = np.eye(alphabet, dtype=np.float32)[msa_tok]  # [S, R, A]

    s_valid = rng.randint(max(2, n_seqs // 2), n_seqs + 1)
    msa_mask = np.zeros((n_seqs, n_res), dtype=np.float32)
    msa_mask[:s_valid] = 1.0
    return {
        "msa": msa, "pair": feat, "target": dist, "msa_mask": msa_mask,
    }


def write_corpus(out_dir, n_res=16, n_seqs=8, alphabet=8, bins=8, train=256,
                 valid=32, noise=1.0, seed=7):
    """``train.rec`` and ``valid.rec`` under ``out_dir``, drawn in that
    order from one ``RandomState(seed)``."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for split, count in (("train", train), ("valid", valid)):
        path = os.path.join(out_dir, split + ".rec")
        with IndexedRecordWriter(path) as w:
            for _ in range(count):
                w.write(make_sample(rng, n_res, n_seqs, alphabet, bins,
                                    noise))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--out-dir", default=".")
    p.add_argument("--n-res", type=int, default=16)
    p.add_argument("--n-seqs", type=int, default=8)
    p.add_argument("--alphabet", type=int, default=8)
    p.add_argument("--bins", type=int, default=8)
    p.add_argument("--train", type=int, default=256)
    p.add_argument("--valid", type=int, default=32)
    p.add_argument("--noise", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=7)
    a = p.parse_args()
    write_corpus(a.out_dir, a.n_res, a.n_seqs, a.alphabet, a.bins, a.train,
                 a.valid, a.noise, a.seed)
    print(f"{a.train} train and {a.valid} valid samples of S={a.n_seqs} "
          f"R={a.n_res} -> {a.out_dir}")


if __name__ == "__main__":
    main()
