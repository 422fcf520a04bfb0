"""The port's SMILES featurizer and PCQM4M-LSC loader (`data/smiles.py`)
against the JAX package's, on the CPU: the same arrays (node features,
edge index, edge features, edge types, the degree feature, the target)
bit for bit, on the SMILES cases of tests/test_smiles.py, on every
molecule of the fixture `tests/fixtures/pcqm4m_kddcup2021` and on an LSC
layout without `split_dict.pt`; the same refusals.
"""

import csv
import gzip
import os

import numpy as np
import pytest

from feta_tmlr_tpu.data import smiles as jsmiles
from feta_tmlr_tpu_torch.data import smiles as tsmiles

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CASES = ("CCO", "c1ccccc1", "[NH4+]", "[O-]C", "CC#N", "CC(=O)C",
         "CC1CCCCC1", "[nH]1cccc1", "c1ccccc1-c1ccccc1", "c1ccc2ccccc2c1",
         "C.C", "C%11CC%11", "c1ccccc1O", "[NH3+]CC([O-])=O",
         "OC(=O)C=CC(=O)O", "C[C@@H](N)C(=O)O", "[13CH3]C", "CS(=O)(=O)C",
         "FC(F)(F)Br", "C#CC=C=C")
GRAPH_FIELDS = ("x", "edge_index", "edge_attr", "edge_type", "degree")


def assert_same_graph(got, want, label):
    for name in GRAPH_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, (label, name)
        np.testing.assert_array_equal(g, w, err_msg=f"{label} {name}")
    np.testing.assert_array_equal(np.float32(got.y), np.float32(want.y),
                                  err_msg=label)


@pytest.mark.parametrize("smiles", CASES)
def test_smiles_arrays_equal_jax(smiles):
    for got, want in zip(tsmiles.smiles_to_graph_arrays(smiles),
                         jsmiles.smiles_to_graph_arrays(smiles)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=smiles)
    assert_same_graph(tsmiles.smiles_to_graph(smiles, 1.5),
                      jsmiles.smiles_to_graph(smiles, 1.5), smiles)


@pytest.mark.parametrize("smiles", ["C1CC", "C?", "C[Xx]", "1CC1"])
def test_smiles_refusals_as_jax(smiles):
    """Unclosed rings, junk tokens and bad bracket atoms raise
    SmilesError; a ring digit with no atom before it fails in both (the
    loader skips such a molecule)."""
    kinds = []
    for mod in (tsmiles, jsmiles):
        with pytest.raises((ValueError, TypeError)) as err:
            mod.smiles_to_graph_arrays(smiles)
        kinds.append(type(err.value).__name__)
    assert kinds[0] == kinds[1]


def _pairs(got, want):
    assert [len(s) for s in got] == [len(s) for s in want]
    for split, (gs, ws) in enumerate(zip(got, want)):
        for i, (g, w) in enumerate(zip(gs, ws)):
            assert_same_graph(g, w, f"split {split} molecule {i}")


def test_lsc_fixture_equals_jax(monkeypatch):
    """Every molecule of the fixture through split_dict.pt, and the first
    three a split (`max_graphs`), against the JAX loader's Python path."""
    monkeypatch.setenv("FETA_NATIVE_SMILES", "0")
    got = tsmiles.load_pcqm4m_lsc(FIXTURES)
    _pairs(got, jsmiles.load_pcqm4m_lsc(FIXTURES))
    assert sum(len(s) for s in got) >= 10
    assert np.isnan(float(got[2][0].y))           # the test gaps withheld
    _pairs(tsmiles.load_pcqm4m_lsc(FIXTURES, max_graphs=3),
           jsmiles.load_pcqm4m_lsc(FIXTURES, max_graphs=3))


def test_lsc_layout_without_split_file_equals_jax(tmp_path, monkeypatch,
                                                  capsys):
    """80/10/10 in file order without split_dict.pt; an unparseable
    molecule is skipped and counted by both."""
    monkeypatch.setenv("FETA_NATIVE_SMILES", "0")
    raw = tmp_path / "pcqm4m_kddcup2021" / "raw"
    raw.mkdir(parents=True)
    rows = [(str(i), s, f"{i / 3:.4f}") for i, s in enumerate(CASES)]
    rows += [("20", "C1CC", "1.0"), ("21", "CCN", "")]
    with gzip.open(raw / "data.csv.gz", "wt", newline="") as f:
        w = csv.writer(f)
        w.writerow(["idx", "smiles", "homolumogap"])
        w.writerows(rows)
    got = tsmiles.load_pcqm4m_lsc(str(tmp_path))
    assert "skipped 1" in capsys.readouterr().out
    _pairs(got, jsmiles.load_pcqm4m_lsc(str(tmp_path)))
    assert [len(s) for s in got] == [17, 2, 2]
    assert np.isnan(float(got[2][-1].y))
    with pytest.raises(FileNotFoundError):
        tsmiles.load_pcqm4m_lsc(str(tmp_path / "absent"))
