"""ZINC molecule loader for the reference's on-disk format.

A directory holds ``<split>.pickle`` (a pickled list of molecule dicts,
as benchmarking-gnns and the LPE/LSPE references store them) and
optional ``<split>.index`` CSV files with the 10k/1k/1k subset indices.
Each molecule dict has:

  ``num_atom``                  int N
  ``atom_type``                 [N] int tensor of atom ids (0..27)
  ``bond_type``                 [N, N] int tensor; 0 = no bond, 1..3 = bond
  ``logP_SA_cycle_normalized``  float regression target

The pickles hold torch tensors, which this package reads natively; numpy
arrays and python numbers in the same schema load too. Graphs come out as
`data.synthetic.zinc_categorical_dataset` makes them: [n, 1] int32 atom
ids, one int32 bond type per edge, a float32 target and the degree
feature. The same reading rules as the JAX package's `data/zinc.py`.
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import List, Optional, Tuple

import numpy as np

import torch

from feta_tmlr_tpu_torch.data.batch import Graph

NUM_ATOM_TYPE = 28  # LSPE/data/molecules.py:105
NUM_BOND_TYPE = 4   # LSPE/data/molecules.py:106

# reference split sizes (LSPE/data/molecules.py:110-117)
ZINC_SUBSET_SIZES = {"train": 10000, "val": 1000, "test": 1000}
ZINC_FULL_SIZES = {"train": 220011, "val": 24445, "test": 5000}


def _to_numpy(x) -> np.ndarray:
    """Torch tensor / numpy array / scalar -> numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def molecule_to_graph(mol: dict) -> Graph:
    """One reference molecule dict -> a host Graph.

    Mirrors MoleculeDGL._prepare (LSPE/data/molecules.py:55-77): edges are
    the nonzeros of the bond-type adjacency (both directions are stored in
    the matrix, so no symmetrisation is applied here — same as the
    reference's ``(adj != 0).nonzero()``).
    """
    atom_type = _to_numpy(mol["atom_type"]).astype(np.int32).reshape(-1)
    bond = _to_numpy(mol["bond_type"])
    n = int(mol.get("num_atom", atom_type.shape[0]))
    if atom_type.shape[0] != n or bond.shape != (n, n):
        raise ValueError(
            f"inconsistent molecule: num_atom={n}, atom_type "
            f"{atom_type.shape}, bond_type {bond.shape}")
    rows, cols = np.nonzero(bond)
    edge_index = np.stack([rows, cols]).astype(np.int32)
    edge_type = bond[rows, cols].astype(np.int32)
    y = np.float32(_to_numpy(mol["logP_SA_cycle_normalized"]).reshape(()))
    g = Graph(x=atom_type[:, None], edge_index=edge_index, y=y,
              edge_type=edge_type)
    g.compute_degree_feature()
    return g


def _read_index(path: str) -> List[int]:
    """<split>.index is a single CSV row of integer indices
    (LSPE/data/molecules.py:33-36)."""
    with open(path, "r") as f:
        rows = [list(map(int, row)) for row in csv.reader(f) if row]
    return rows[0]


def load_zinc_split(data_dir: str, split: str,
                    num_graphs: Optional[int] = None,
                    use_index: Optional[bool] = None) -> List[Graph]:
    """Load one ZINC split from ``<data_dir>/<split>.pickle``.

    Reference semantics (LSPE/data/molecules.py:32-37): ``num_graphs`` in
    {10000, 1000} selects the published subset via ``<split>.index`` and
    asserts the count. ``use_index`` overrides the trigger (so small fixture
    datasets with index files also exercise the subset path); any other
    ``num_graphs`` head-slices (smoke runs), None keeps everything.
    """
    with open(os.path.join(data_dir, f"{split}.pickle"), "rb") as f:
        data = pickle.load(f)
    if use_index is None:
        use_index = num_graphs in (10000, 1000)
    if use_index:
        idx = _read_index(os.path.join(data_dir, f"{split}.index"))
        data = [data[i] for i in idx]
        if num_graphs is not None and len(data) != num_graphs:
            raise ValueError(
                f"{split}.index selects {len(data)} graphs, expected "
                f"{num_graphs} (available idx: train/val/test => 10k/1k/1k)")
    elif num_graphs is not None:
        data = data[:num_graphs]
    return [molecule_to_graph(m) for m in data]


def load_zinc(data_dir: str, subset: bool = True,
              max_graphs_per_split: Optional[int] = None,
              ) -> Tuple[List[Graph], List[Graph], List[Graph]]:
    """(train, val, test) Graph lists.

    subset=True loads the standard ZINC-10k/1k/1k via the index files when
    present (MoleculeDatasetDGL 'Zinc' mode); subset=False loads everything
    in the pickles ('ZINC-full' mode). ``max_graphs_per_split`` additionally
    head-slices each split (memory guard for CI / smoke runs).
    """
    splits = []
    for split in ("train", "val", "test"):
        has_index = os.path.exists(os.path.join(data_dir, f"{split}.index"))
        if subset and not has_index:
            print(f"[warn] ZINC subset requested but {split}.index is "
                  f"missing under {data_dir} - loading the FULL {split} "
                  "pickle (the published protocol selects 10k/1k/1k via "
                  "the index files)")
        graphs = load_zinc_split(data_dir, split,
                                 use_index=subset and has_index)
        if max_graphs_per_split is not None:
            graphs = graphs[:max_graphs_per_split]
        splits.append(graphs)
    return tuple(splits)


def find_zinc_dir(datadir: str) -> Optional[str]:
    """Resolve the molecules directory under a data root.

    Accepts either the directory itself or a root containing the reference's
    ``molecules/`` layout (LSPE keeps them at ``data/molecules``; 'ZINC-full'
    at ``data/molecules/zinc_full``, LSPE/data/molecules.py:108-117).
    """
    if not datadir:
        return None
    for cand in (datadir,
                 os.path.join(datadir, "molecules"),
                 os.path.join(datadir, "ZINC"),
                 os.path.join(datadir, "zinc")):
        if os.path.exists(os.path.join(cand, "train.pickle")):
            return cand
    return None


def load_zinc_or_synthetic(datadir: str, seed: int = 0,
                           n_synthetic: int = 96,
                           subset: bool = True,
                           max_graphs_per_split: Optional[int] = None):
    """(train, val, test, used_real). Falls back to the shape-matched
    synthetic generator when no real pickles are found."""
    real = find_zinc_dir(datadir)
    if real is not None:
        tr, va, te = load_zinc(real, subset=subset,
                               max_graphs_per_split=max_graphs_per_split)
        print(f"[data] loaded ZINC from {real}: "
              f"{len(tr)}/{len(va)}/{len(te)} graphs")
        return tr, va, te, True
    from feta_tmlr_tpu_torch.data.synthetic import (
        zinc_categorical_dataset)
    print(f"[warn] no ZINC pickles under {datadir!r} - synthetic fallback "
          f"({n_synthetic} graphs)")
    graphs = zinc_categorical_dataset(seed=seed, n_graphs=n_synthetic)
    n = len(graphs)
    return (graphs[: int(0.8 * n)],
            graphs[int(0.8 * n): int(0.9 * n)],
            graphs[int(0.9 * n):], False)
