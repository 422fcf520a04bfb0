"""The port's CUDA kernels on the card: each held to its plain PyTorch
version, the wrappers' operand checks, and a small model served and
trained on CUDA against the CPU path.

These tests need an NVIDIA card and skip without one. They import no JAX,
so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: kernels rtol 1e-4 / atol 1e-5 (f32, sums in another order); the
two-layer model rtol 1e-4 / atol 1e-4, its gradients rtol 1e-3 / atol 1e-5.
"""

import copy

import numpy as np
import pytest
import torch

from feta_tmlr_tpu_torch.data.batch import collate_graphs
from feta_tmlr_tpu_torch.data.synthetic import sbm_like_dataset
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformerGenGCNSBM
from feta_tmlr_tpu_torch.ops.kernels import colstat as tcs
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as tfl
from feta_tmlr_tpu_torch.ops.kernels.common import bwd_row_constants
from feta_tmlr_tpu_torch.pe.encodings import DiffusionEncoding, LapEncoding
from feta_tmlr_tpu_torch.serve import Predictor
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer

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
    with pytest.raises(RuntimeError, match="not differentiable"):
        tfl.flash_fwd(vw=vw.to(cuda).requires_grad_(), **gops)
    with torch.no_grad():
        _, m, se, su = tfl.flash_fwd(vw=vw.to(cuda), **gops)
    with pytest.raises(RuntimeError, match="not differentiable"):
        tcs.colstat(**gops, m=m, se=se.requires_grad_(), su=su)
    args = _bwd_args(ops, vw)
    gargs = [t.to(cuda) if torch.is_tensor(t) else t for t in args]
    for fn in (tfl.flash_bwd_q, tfl.flash_bwd_k):
        bad = list(gargs)
        bad[10] = gargs[10][..., :4].contiguous()      # g narrower than vw
        with pytest.raises(ValueError, match="g has shape"):
            fn(*bad)
        bad[10] = gargs[10].transpose(2, 3).contiguous().transpose(2, 3)
        with pytest.raises(ValueError, match="contiguous"):
            fn(*bad)


def _bwd_args(ops, vw, guard_rows=4):
    """Backward operands on the CPU: the forward's statistics from the
    plain version, a random cotangent, and the row constants. su is zeroed
    on the first `guard_rows` real rows of graph 1, so the |su/se| <= 1e-9
    branch (beta = 0, c = r != 0) runs there."""
    outh, m, se, su = tfl.flash_fwd_plain(vw=vw, **ops)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(
        tuple(outh.shape)).astype(np.float32))
    su = su.clone()
    su[1:2, :, :guard_rows] = 0.0
    consts = bwd_row_constants(g, outh, se, su, ops["mask"])
    return (ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"], vw,
            ops["pe"], ops["deg"], ops["mask"], ops["inv_sqrt"], g, m,
            *consts)


@pytest.mark.cuda
@pytest.mark.parametrize("n,pad,dv,with_mod", [
    (200, 7, 8, True), (256, 0, 64, True), (70, 9, 16, False),
    (1, 0, 8, True)])
def test_cuda_backward_kernels_match_plain(cuda, n, pad, dv, with_mod):
    ops, vw = _ops(7, 2, 4, n, 64, dv, pad, with_mod)
    args = _bwd_args(ops, vw, guard_rows=min(n, 4))
    gargs = [t.to(cuda) if torch.is_tensor(t) else t for t in args]
    before = tfl.flash_bwd_q.launches, tfl.flash_bwd_k.launches
    want = tfl.flash_bwd_plain(*args)
    got = tfl.flash_bwd(*gargs)
    torch.cuda.synchronize()
    _close(got, want)
    again = tfl.flash_bwd(*gargs)           # no atomics: bit-identical
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (tfl.flash_bwd_q.launches, tfl.flash_bwd_k.launches) == (
        before[0] + 2, before[1] + 2)


_SMALL = dict(in_size=3, nb_class=2, d_model=16, nb_heads=2,
              dim_feedforward=32, dropout=0.0, nb_layers=2, batch_norm=True,
              lap_pos_enc=True, lap_pos_enc_dim=4, filter_order=3, seed=5)


def _graphs(n_graphs):
    graphs = sbm_like_dataset(seed=3, n_graphs=n_graphs, n_nodes=64)
    DiffusionEncoding(beta=1.0).apply_to(graphs)
    LapEncoding(_SMALL["lap_pos_enc_dim"]).apply_to(graphs)
    return graphs


@pytest.mark.cuda
def test_cuda_training_step_matches_cpu(cuda):
    batch = collate_graphs(_graphs(2), max_nodes=64, node_labels=True)
    cpu_model = DiffGraphTransformerGenGCNSBM(**_SMALL, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    cfg = TrainConfig(regularization=0.1, sign_flip=False)
    counts = lambda: (tfl.flash_fwd.launches, tcs.colstat.launches,
                      tfl.flash_bwd_q.launches, tfl.flash_bwd_k.launches)
    before = counts()
    loss_gpu = Trainer(gpu_model, cfg).step(batch.to(cuda))
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 2, 2, 2)
    loss_cpu = Trainer(cpu_model, cfg).step(batch)
    np.testing.assert_allclose(float(loss_gpu), float(loss_cpu), rtol=1e-4)
    want = dict(cpu_model.named_parameters())
    for name, p in gpu_model.named_parameters():
        np.testing.assert_allclose(p.grad.cpu().numpy(),
                                   want[name].grad.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)


@pytest.mark.cuda
def test_cuda_predictor_matches_cpu(cuda):
    graphs = _graphs(3)
    kw = dict(max_batch=2, node_level=True,
              collate_kwargs={"max_nodes": 64, "node_labels": True})
    want = Predictor(DiffGraphTransformerGenGCNSBM(**_SMALL, device="cpu"),
                     device="cpu", **kw).predict(graphs)
    tfl.flash_fwd.launches = tcs.colstat.launches = 0
    got = Predictor(DiffGraphTransformerGenGCNSBM(**_SMALL), **kw).predict(
        graphs)                                   # default device: CUDA
    assert (tfl.flash_fwd.launches, tcs.colstat.launches) == (4, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
