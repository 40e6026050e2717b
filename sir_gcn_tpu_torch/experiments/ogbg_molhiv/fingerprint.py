"""Molecular fingerprint generation (a copy of
``experiments/ogbg_molhiv/fingerprint.py``; reference
``benchmark-datasets/ogbg-molhiv/fingerprint.py``): Morgan / MACCS / RDKit
fingerprints from SMILES, used with external (non-GNN) models — "not used"
in the published results per reference ``README.md:7``.

Requires RDKit, which is not a framework dependency; the module degrades to
a clear error when it is absent."""

from __future__ import annotations

import argparse

import numpy as np


def generate_fingerprint(smiles: str, kind: str = "morgan",
                         radius: int = 2, n_bits: int = 2048) -> np.ndarray:
    try:
        from rdkit import Chem
        from rdkit.Chem import AllChem, MACCSkeys, RDKFingerprint
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "fingerprint generation needs RDKit (pip install rdkit); it is "
            "an offline preprocessing tool, not a framework dependency"
        ) from e

    mol = Chem.MolFromSmiles(smiles)
    if kind == "morgan":
        fp = AllChem.GetMorganFingerprintAsBitVect(mol, radius,
                                                   nBits=n_bits)
    elif kind == "maccs":
        fp = MACCSkeys.GenMACCSKeys(mol)
    elif kind == "rdkit":
        fp = RDKFingerprint(mol)
    else:
        raise NotImplementedError(kind)
    return np.asarray(fp, dtype=np.int8)


def main(argv=None):  # pragma: no cover
    p = argparse.ArgumentParser("Generate molhiv fingerprints")
    p.add_argument("--kind", default="morgan",
                   choices=["morgan", "maccs", "rdkit"])
    p.add_argument("--radius", type=int, default=2)
    p.add_argument("--n-bits", type=int, default=2048)
    p.add_argument("--smiles-csv", default="dataset/ogbg_molhiv/mapping/"
                                           "mol.csv.gz")
    p.add_argument("--out", default="fingerprints.npy")
    args = p.parse_args(argv)

    import gzip
    import csv

    smiles = []
    with gzip.open(args.smiles_csv, "rt") as f:
        for row in csv.DictReader(f):
            smiles.append(row["smiles"])
    fps = np.stack([generate_fingerprint(s, args.kind, args.radius,
                                         args.n_bits) for s in smiles])
    np.save(args.out, fps)
    print(f"saved {fps.shape} -> {args.out}")


if __name__ == "__main__":  # pragma: no cover
    main()
