"""Write a synthetic pair-regression corpus for the pair example (a copy
of ``examples/pair/example_data/make_data.py``; for one ``RandomState``
it gives the same records)::

    python -m unicore_tpu_torch.examples.pair.make_data -o OUT_DIR \\
        [--n-points 32] [--bins 16] [--train 512] [--valid 64] \\
        [--noise 0.5] [--seed 7]

Each sample is a random 3-D point cloud of N points: the target is its
distance matrix, the input pair features a one-hot binning of a noisy,
symmetrized distance, so the model refines geometry through the triangle
updates.
"""

import argparse
import os

import numpy as np

from ...data import IndexedRecordWriter


def make_sample(rng, n_points, bins, noise):
    xyz = rng.randn(n_points, 3).astype(np.float32) * 2.0
    diff = xyz[:, None, :] - xyz[None, :, :]
    dist = np.sqrt((diff ** 2).sum(-1)).astype(np.float32)  # [N, N]
    noisy = dist + rng.randn(n_points, n_points).astype(np.float32) * noise
    noisy = np.maximum(0.5 * (noisy + noisy.T), 0.0)  # symmetrize
    # the first edge above zero, so that bin 0 is reachable
    hi = np.percentile(dist, 97)
    edges = np.linspace(hi / (bins - 1), hi, bins - 1)
    feat = np.eye(bins, dtype=np.float32)[np.digitize(noisy, edges)]
    return {"pair": feat, "target": dist}


def write_corpus(out_dir, n_points=32, bins=16, train=512, valid=64,
                 noise=0.5, seed=7):
    """``train.rec`` and ``valid.rec`` under ``out_dir``, drawn in that
    order from one ``RandomState(seed)``."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    for split, count in (("train", train), ("valid", valid)):
        with IndexedRecordWriter(os.path.join(out_dir, split + ".rec")) as w:
            for _ in range(count):
                w.write(make_sample(rng, n_points, bins, noise))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--out-dir", default=".")
    p.add_argument("--n-points", type=int, default=32)
    p.add_argument("--bins", type=int, default=16)
    p.add_argument("--train", type=int, default=512)
    p.add_argument("--valid", type=int, default=64)
    p.add_argument("--noise", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=7)
    a = p.parse_args()
    write_corpus(a.out_dir, a.n_points, a.bins, a.train, a.valid, a.noise,
                 a.seed)
    print(f"{a.train} train and {a.valid} valid samples of "
          f"N={a.n_points} -> {a.out_dir}")


if __name__ == "__main__":
    main()
