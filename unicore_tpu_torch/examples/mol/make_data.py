"""Write a synthetic molecular-conformer corpus for the ``mol`` task (a
copy of ``examples/mol/example_data/make_data.py``; for the same
arguments and seed it writes the same records and ``dict.txt``)::

    python -m unicore_tpu_torch.examples.mol.make_data -o OUT_DIR \\
        [--train 400] [--valid 40] [--min-atoms 8] [--max-atoms 24] \\
        [--atom-types 6] [--seed 7]

Each record is a pickled dict ``{"atoms": [str, ...], "coord":
float32 [n, 3]}``: element symbols plus a 3-D conformer.  Molecules are
chain-grown: each atom sits a bond length (~1.5 A, jittered per
element) from the previous one, in a random direction biased away from
the previous bond, so pairwise distances carry learnable structure.
``train.rec`` / ``valid.rec`` are ``IndexedRecordWriter`` stores, and
``dict.txt`` lists the element symbols by count.
"""

import argparse
import collections
import os

import numpy as np

from ...data import IndexedRecordWriter

ELEMENTS = ["C", "N", "O", "S", "P", "F", "Cl", "Br"]
# per-element bond-length perturbation: type -> distance regularities
BOND_DELTA = {e: 0.06 * i for i, e in enumerate(ELEMENTS)}


def _unit(v):
    return v / (np.linalg.norm(v) + 1e-9)


def grow_molecule(rng, n_atoms, n_types):
    types = rng.randint(0, n_types, size=n_atoms)
    symbols = [ELEMENTS[t] for t in types]
    coord = np.zeros((n_atoms, 3), dtype=np.float32)
    direction = _unit(rng.normal(size=3))
    for i in range(1, n_atoms):
        bond = 1.5 + BOND_DELTA[symbols[i]] + 0.02 * rng.normal()
        # bias the new bond direction to keep ~109 degree chain angles
        direction = _unit(direction + 0.9 * rng.normal(size=3))
        coord[i] = coord[i - 1] + bond * direction
    coord -= coord.mean(axis=0, keepdims=True)
    return symbols, coord


def write_split(path, rng, n_mol, min_atoms, max_atoms, n_types, counter):
    with IndexedRecordWriter(path) as out:
        for _ in range(n_mol):
            n_atoms = rng.randint(min_atoms, max_atoms + 1)
            symbols, coord = grow_molecule(rng, n_atoms, n_types)
            counter.update(symbols)
            out.write({"atoms": symbols, "coord": coord})


def write_corpus(out_dir, train=400, valid=40, min_atoms=8, max_atoms=24,
                 atom_types=6, seed=7):
    """``train.rec``, ``valid.rec`` (drawn in that order from one
    ``RandomState(seed)``) and ``dict.txt`` under ``out_dir``."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    counter = collections.Counter()
    for split, n_mol in (("train", train), ("valid", valid)):
        write_split(os.path.join(out_dir, split + ".rec"), rng, n_mol,
                    min_atoms, max_atoms, atom_types, counter)
    with open(os.path.join(out_dir, "dict.txt"), "w", encoding="utf-8") as f:
        for sym, cnt in counter.most_common():
            f.write(f"{sym} {cnt}\n")
    return counter


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-o", "--out-dir", default=".")
    p.add_argument("--train", type=int, default=400, help="training molecules")
    p.add_argument("--valid", type=int, default=40, help="validation molecules")
    p.add_argument("--min-atoms", type=int, default=8)
    p.add_argument("--max-atoms", type=int, default=24)
    p.add_argument("--atom-types", type=int, default=6,
                   help="how many element symbols to draw from (<= 8)")
    p.add_argument("--seed", type=int, default=7)
    a = p.parse_args()
    counter = write_corpus(a.out_dir, a.train, a.valid, a.min_atoms,
                           a.max_atoms, a.atom_types, a.seed)
    print(f"{a.train} train and {a.valid} valid conformers, "
          f"{len(counter)} element types -> {a.out_dir}")


if __name__ == "__main__":
    main()
