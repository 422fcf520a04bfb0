"""The port's CUDA kernels on the card: each held to its plain PyTorch
version, the wrappers' operand checks, and a small model served on CUDA
against the CPU path.

These tests need an NVIDIA card and skip without one. They import no JAX,
so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: kernels rtol 1e-4 / atol 1e-5 (f32, sums in another order); the
two-layer model rtol 1e-4 / atol 1e-4.
"""

import numpy as np
import pytest
import torch

from feta_tmlr_tpu_torch.data.synthetic import sbm_like_dataset
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformerGenGCNSBM
from feta_tmlr_tpu_torch.ops.kernels import colstat as tcs
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as tfl
from feta_tmlr_tpu_torch.pe.encodings import DiffusionEncoding, LapEncoding
from feta_tmlr_tpu_torch.serve import Predictor

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ops(seed, b, h, n, d, dv, pad, with_mod=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    mask = np.ones((b, n), bool)
    mask[0, n - pad:] = False
    pe = rng.random((b, n, n)) * mask[:, :, None] * mask[:, None, :]
    deg = rng.random((b, n)) * mask
    ops = tfl.prepare(
        0.3 * f(b, h, n, d), 0.3 * f(b, n, d), f(b, n, h), f(b, n, h), f(h),
        torch.from_numpy(mask),
        torch.from_numpy(pe.astype(np.float32)) if with_mod else None,
        torch.from_numpy(deg.astype(np.float32)) if with_mod else None)
    return ops, f(b, h, n, dv)


def _to(ops, device):
    return {k: v.to(device) if torch.is_tensor(v) else v
            for k, v in ops.items()}


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,pad,dv,with_mod", [
    (200, 7, 8, True), (256, 0, 64, True), (70, 9, 16, False),
    (1, 0, 8, True)])
def test_cuda_kernels_match_plain(cuda, n, pad, dv, with_mod):
    ops, vw = _ops(7, 2, 4, n, 64, dv, pad, with_mod)
    gops = _to(ops, cuda)
    before = tfl.flash_fwd.launches, tcs.colstat.launches
    want = tfl.flash_fwd_plain(vw=vw, **ops)
    got = tfl.flash_fwd(vw=vw.to(cuda), **gops)
    torch.cuda.synchronize()
    _close(got, want)
    stats = dict(m=want[1], se=want[2], su=want[3])
    gstats = _to(stats, cuda)
    for wq in (None, want[2]):
        want_cs = tcs.colstat_plain(**ops, **stats, wq=wq)
        got_cs = tcs.colstat(**gops, **gstats,
                             wq=None if wq is None else wq.to(cuda))
        torch.cuda.synchronize()
        _close(got_cs, want_cs)
    assert (tfl.flash_fwd.launches, tcs.colstat.launches) == (
        before[0] + 1, before[1] + 2)


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ops, vw = _ops(8, 1, 2, 32, 16, 8, 3)
    gops = _to(ops, cuda)
    with pytest.raises(ValueError, match="value width"):
        tfl.flash_fwd(vw=torch.zeros(1, 2, 32, 65, device=cuda), **gops)
    with pytest.raises(ValueError, match="contiguous"):
        tfl.flash_fwd(vw=vw.to(cuda).transpose(2, 3).contiguous()
                      .transpose(2, 3), **gops)
    with pytest.raises(ValueError, match="float32"):
        tfl.flash_fwd(vw=vw.to(cuda).double(), **gops)
    with pytest.raises(NotImplementedError, match="no backward"):
        tfl.flash_fwd(vw=vw.to(cuda).requires_grad_(), **gops)


@pytest.mark.cuda
def test_cuda_predictor_matches_cpu(cuda):
    graphs = sbm_like_dataset(seed=3, n_graphs=3, n_nodes=64)
    DiffusionEncoding(beta=1.0).apply_to(graphs)
    LapEncoding(4).apply_to(graphs)
    cfg = dict(in_size=3, nb_class=2, d_model=16, nb_heads=2,
               dim_feedforward=32, dropout=0.0, nb_layers=2, batch_norm=True,
               lap_pos_enc=True, lap_pos_enc_dim=4, filter_order=3, seed=5)
    kw = dict(max_batch=2, node_level=True,
              collate_kwargs={"max_nodes": 64, "node_labels": True})
    want = Predictor(DiffGraphTransformerGenGCNSBM(**cfg, device="cpu"),
                     device="cpu", **kw).predict(graphs)
    tfl.flash_fwd.launches = tcs.colstat.launches = 0
    got = Predictor(DiffGraphTransformerGenGCNSBM(**cfg), **kw).predict(
        graphs)                                   # default device: CUDA
    assert (tfl.flash_fwd.launches, tcs.colstat.launches) == (4, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
