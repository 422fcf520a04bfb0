"""The port's CUDA kernels on the card: each held to its plain PyTorch
version, the wrappers' operand checks, and small SBM, SAN and ZINC models
served and trained on CUDA against the CPU path.

These tests need an NVIDIA card and skip without one. They import no JAX,
so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: kernels rtol 1e-4 / atol 1e-5 (f32, sums in another order),
dropout masks bit-equal; the two-layer SBM model rtol 1e-4 / atol 1e-4
and its gradients rtol 1e-3 / atol 1e-5; the two-layer SAN model's outputs
rtol 1e-4 / atol 1e-4 and its gradients within 1e-3 of each tensor's
largest entry (eigen-PE dropout 0.1 on both sides, the same masks); the
two-layer ZINC model on the modulation and fused routes and the two-layer
molhiv model at d_model 128 on the flash route as the SBM model. The LPE
tier's fused-MLP shapes (width 16 in two forward slabs; the edge
eigen-PE head's B*N*N*m rows) are held to the plain versions run on the
card, and a train-mode step of SANNet and GATFeTANet with dropout 0.2 to
the CPU's step from the same seed (gradients within 1e-3 of each
tensor's largest entry): one seed, the same masks on both. The LSPE
nets (GraphiT-Spectra-LSPE, GraphiT-LSPE, SAN-LSPE, GatedGCN-LSPE dense
and sparse, PNA-LSPE dense and sparse with the GRU) at two layers: a
train-mode step on CUDA against the CPU's from the same weights (loss
rtol 1e-4, gradients within 1e-3 of each tensor's largest entry), the
served logits rtol 1e-4 / atol 1e-4, and no kernel launched. The
GraphiT baselines at two layers as the ZINC model; the attention kernels
with pe and deg absent at the ZINC batch; a step of the FeTA model with
`remat` bit-equal to the same step without it; the molhiv baseline's
refusal of the fused and folded kernels at d_model 128. The packed ZINC
model (rows of 128 nodes) as the ZINC model, launching no kernel, and the
unpacked model's flash launches unchanged beside it.
"""

import copy

import numpy as np
import pytest
import torch

from chip_smoke import (EDGE_ROWS, FUSED_CPU32_FACTOR, PATTERN_ROWS,
                        masked_cells, mlp_g_scale, mlp_inputs, mlp_masks)
from feta_tmlr_tpu_torch.data.batch import collate_graphs
from feta_tmlr_tpu_torch.data.pack import pack_graphs, pack_rows
from feta_tmlr_tpu_torch.data.synthetic import (
    ogb_like_dataset,
    sbm_like_dataset,
    zinc_categorical_dataset,
    zinc_like_dataset,
)
from feta_tmlr_tpu_torch.nn.models import (
    DiffGraphTransformer,
    DiffGraphTransformerGCN,
    DiffGraphTransformerGenGCN,
    DiffGraphTransformerGenGCNSBM,
    DiffGraphTransformerMolHiv,
    GraphTransformer,
)
from feta_tmlr_tpu_torch.nn.ogb import DiffGraphTransformerGenGCNMolHiv
from feta_tmlr_tpu_torch.nn.packed import PackedDiffGraphTransformerGenGCN
from feta_tmlr_tpu_torch.nn.gat import GATFeTANet
from feta_tmlr_tpu_torch.nn.gatedgcn import GatedGCNLSPENet
from feta_tmlr_tpu_torch.nn.lspe import GraphiTSpectraNet
from feta_tmlr_tpu_torch.nn.pna import PNALSPENet
from feta_tmlr_tpu_torch.nn.san_lspe import SANLSPENet
from feta_tmlr_tpu_torch.nn.san import SANNet, SANNodeSpectra, hash_dropout
from feta_tmlr_tpu_torch.ops.kernels import colstat as tcs
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as tfl
from feta_tmlr_tpu_torch.ops.kernels import fused_attention as tfa
from feta_tmlr_tpu_torch.ops.kernels import fused_mlp as tfm
from feta_tmlr_tpu_torch.ops.kernels import modulation as tmod
from feta_tmlr_tpu_torch.ops.kernels.common import bwd_row_constants
from feta_tmlr_tpu_torch.pe.encodings import DiffusionEncoding, LapEncoding
from feta_tmlr_tpu_torch.pe.encodings import PStepRWEncoding
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp
from feta_tmlr_tpu_torch.pe.rwpe import apply_rwpe
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
@pytest.mark.parametrize("n", [1, 17, 48, 64, 65, 200, 2048])
@pytest.mark.parametrize("with_mod", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_cuda_colstat_matches_plain_at_the_tiles_edges(cuda, n, with_mod,
                                                       weighted):
    """colstat at N across its 64-key blocks and 64-query tiles (the ZINC
    batch's 48, the fold step's 2048), pe zero on graph 0's first query rows
    (the |su/se| <= 1e-9 branch), wq absent or given: within the tolerance
    of plain, two runs bit-identical, one launch counted per call."""
    pad = min(n - 1, 7)
    ops, vw = _ops(n, 2, 4, n, 64, 8, pad, with_mod)
    if with_mod:
        ops["pe"][0, :3] = 0.0
    _, m, se, su = tfl.flash_fwd_plain(vw=vw, **ops)
    wq = torch.rand(se.shape, generator=torch.Generator().manual_seed(n))
    stats = dict(m=m, se=se, su=su, wq=wq if weighted else None)
    gops, gstats = _to(ops, cuda), _to(stats, cuda)
    before = tcs.colstat.launches
    got = tcs.colstat(**gops, **gstats)
    again = tcs.colstat(**gops, **gstats)
    torch.cuda.synchronize()
    assert tcs.colstat.launches == before + 2
    assert all(map(torch.equal, got, again))
    _close(got, tcs.colstat_plain(**ops, **stats))


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ops, vw = _ops(8, 1, 2, 32, 16, 8, 3)
    gops = _to(ops, cuda)
    with pytest.raises(ValueError, match="value width"):
        tfl.flash_fwd(vw=torch.zeros(1, 2, 32, 129, device=cuda), **gops)
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


# the unfolded forward's and colstat's wide rows (D or dv over 64, up to
# 128: the OGB molecular models' d_model), two value chunks at dv 128,
# the filtered layer's dv 16, K edges at D = 100 and 70 (4-byte staging),
# N of 1, 13 and ragged
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,pad,d,dv,with_mod", [
    (2, 8, 200, 7, 128, 128, True), (2, 8, 222, 9, 128, 16, True),
    (1, 3, 65, 3, 100, 100, False), (1, 1, 13, 2, 70, 70, True),
    (2, 4, 1, 0, 128, 128, True), (4, 8, 1024, 60, 128, 128, True)])
def test_cuda_wide_forward_and_colstat_match_plain(cuda, b, h, n, pad, d, dv,
                                                   with_mod):
    """flash_fwd and colstat at D = 128 against their plain versions, two
    runs bit-identical; the folded forward refuses the width."""
    ops, vw = _ops(12, b, h, n, d, dv, pad, with_mod)
    gops, gvw = _to(ops, cuda), vw.to(cuda)
    before = tfl.flash_fwd.launches, tcs.colstat.launches
    want = tfl.flash_fwd_plain(vw=vw, **ops)
    got, again = tfl.flash_fwd(vw=gvw, **gops), tfl.flash_fwd(vw=gvw, **gops)
    torch.cuda.synchronize()
    _close(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    stats = dict(m=want[1], se=want[2], su=want[3])
    for wq in (None, want[2]):
        got_cs = tcs.colstat(**gops, **_to(stats, cuda),
                             wq=None if wq is None else wq.to(cuda))
        torch.cuda.synchronize()
        _close(got_cs, tcs.colstat_plain(**ops, **stats, wq=wq))
    assert (tfl.flash_fwd.launches, tcs.colstat.launches) == (
        before[0] + 2, before[1] + 2)
    with pytest.raises(ValueError, match="> 64"):
        tfl.flash_fwd_hf(vw=gvw, **gops)


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


# the passes' tensor-core tiles (key pass: 64 keys x 32-query tiles; query
# pass: 64 queries in strips of 16 x 32-key tiles) at their edges: D and DV
# not multiples of 8, N below one tile and one past a key or a query tile,
# H of 1, 3 and 8, the ZINC batch (B=128, N=48), the N=2048 training shape
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,pad,d,dv,with_mod", [
    (2, 4, 200, 7, 64, 8, True), (2, 4, 256, 0, 64, 64, True),
    (2, 4, 70, 9, 64, 16, False), (2, 4, 1, 0, 64, 8, True),
    (2, 3, 100, 5, 20, 12, True), (1, 1, 13, 2, 20, 12, True),
    (2, 8, 65, 0, 64, 64, True), (2, 8, 33, 1, 64, 8, True),
    (128, 8, 48, 11, 64, 64, True), (128, 8, 48, 11, 64, 8, True),
    (2, 8, 257, 3, 64, 64, True), (1, 3, 257, 4, 20, 12, True),
    (1, 8, 2048, 100, 64, 64, True),
    # the wide rows (D or dv over 64): two column chunks, the filtered
    # layer's dv 16, a K edge inside the second chunk, 4-byte staging
    (2, 8, 200, 7, 128, 128, True), (2, 8, 70, 9, 128, 16, False),
    (1, 3, 65, 3, 100, 100, True), (1, 1, 13, 2, 70, 70, True),
    (4, 8, 1024, 60, 128, 128, True)])
def test_cuda_backward_kernels_match_plain(cuda, b, h, n, pad, d, dv,
                                           with_mod):
    ops, vw = _ops(7, b, h, n, d, dv, pad, with_mod)
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


# the folded key pass's tiles (32 keys x 8-query tiles, the query loop
# split over 1-4 blocks) and the folded query pass's (one 16-query strip a
# head x 32-key tiles) at their edges, as above; B=1 at N=2048 and N=257
# take 2 and 4 key-pass splits on a 132-SM card
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,pad,d,dv,with_mod", [
    (2, 4, 200, 7, 64, 8, True), (2, 8, 256, 0, 64, 64, True),
    (2, 8, 130, 5, 64, 8, True), (2, 2, 70, 9, 64, 16, False),
    (2, 4, 1, 0, 64, 8, True), (2, 3, 100, 5, 20, 12, True),
    (1, 1, 13, 2, 20, 12, True), (2, 8, 31, 0, 64, 64, True),
    (2, 8, 33, 1, 64, 64, True), (1, 8, 9, 0, 64, 8, True),
    (1, 8, 2048, 100, 64, 64, True), (1, 3, 257, 4, 20, 12, True),
    (128, 8, 48, 11, 64, 64, True), (128, 8, 48, 11, 64, 8, True),
    (2, 8, 65, 0, 64, 64, True), (2, 6, 100, 5, 64, 16, True),
    (2, 5, 70, 3, 40, 24, True)])
def test_cuda_folded_kernels_match_plain_and_unfolded(cuda, b, h, n, pad, d,
                                                      dv, with_mod):
    """The head-folded kernels against their plain versions (the unfolded
    kernels' own) and against the unfolded kernels, guard rows included;
    two backward runs bit-identical; one launch per call. The forwards
    and the query passes are each one kernel body on two grids
    (`csrc/fwd.cuh`, `csrc/bwd_q.cuh`), each 16-query strip summed alike,
    so folded and unfolded agree bit for bit; the key passes agree within
    the kernels' tolerance, not bit for bit: their tiles, and so their
    sums, differ (8 against 32 queries a fresh partial, and the folded
    pass's query splits)."""
    ops, vw = _ops(7, b, h, n, d, dv, pad, with_mod)
    args = _bwd_args(ops, vw, guard_rows=min(n, 4))
    gargs = [t.to(cuda) if torch.is_tensor(t) else t for t in args]
    folded = (tfl.flash_fwd_hf, tfl.flash_bwd_q_hf, tfl.flash_bwd_k_hf)
    before = [f.launches for f in folded]
    got_f = tfl.flash_fwd_hf(*gargs[:10])
    got_b = tfl.flash_bwd(*gargs, head_fold=True)
    again = tfl.flash_bwd(*gargs, head_fold=True)
    twins = tfl.flash_fwd(*gargs[:10]) + tfl.flash_bwd(*gargs)
    torch.cuda.synchronize()
    _close(got_f, tfl.flash_fwd_plain(*args[:10]))
    _close(got_b, tfl.flash_bwd_plain(*args))
    for got, twin in zip(got_f + got_b, twins):
        np.testing.assert_allclose(got.cpu().numpy(), twin.cpu().numpy(),
                                   **TOL)
    assert all(torch.equal(a, b) for a, b in zip(got_b, again))
    assert all(torch.equal(a, b) for a, b in zip(got_f, twins[:4]))
    assert all(torch.equal(a, b) for a, b in zip(got_b[:2], twins[4:6]))
    assert [f.launches for f in folded] == [before[0] + 1, before[1] + 2,
                                            before[2] + 2]


# the forwards' tiles (strips of 16 queries, 32-key tiles of which each of a
# strip's two warps takes 16 keys) at their edges: N of 1 (one key), 13
# (within warp 0's keys), 65 (one past a query and a key tile), 200 and
# 1990 (ragged), D = 20 with dv = 12, H of 1 and 3
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,pad,d,dv,with_mod", [
    (2, 1, 1, 0, 64, 8, True), (1, 3, 13, 2, 20, 12, True),
    (2, 3, 65, 0, 64, 64, True), (2, 1, 200, 7, 20, 12, False),
    (1, 8, 1990, 9, 64, 8, True), (2, 3, 48, 11, 64, 64, True),
    (1, 1, 33, 1, 20, 12, True)])
def test_cuda_forwards_at_the_tiles_edges(cuda, b, h, n, pad, d, dv,
                                          with_mod):
    """Both forwards against the plain version, bit-equal to each other
    (outh, m, se, su) and bit-identical from run to run, one launch a
    call."""
    ops, vw = _ops(11, b, h, n, d, dv, pad, with_mod)
    args = (ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"], vw,
            ops["pe"], ops["deg"], ops["mask"], ops["inv_sqrt"])
    gargs = [t.to(cuda) if torch.is_tensor(t) else t for t in args]
    before = tfl.flash_fwd.launches, tfl.flash_fwd_hf.launches
    got, again = tfl.flash_fwd(*gargs), tfl.flash_fwd(*gargs)
    folded = tfl.flash_fwd_hf(*gargs)
    torch.cuda.synchronize()
    _close(got, tfl.flash_fwd_plain(*args))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, folded))
    assert (tfl.flash_fwd.launches, tfl.flash_fwd_hf.launches) == (
        before[0] + 2, before[1] + 1)


@pytest.mark.cuda
def test_cuda_folded_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ops, vw = _ops(8, 1, 9, 32, 16, 8, 3)
    with pytest.raises(ValueError, match="9 heads > 8"):
        tfl.flash_fwd_hf(vw=vw.to(cuda), **_to(ops, cuda))
    ops, vw = _ops(8, 1, 2, 32, 16, 8, 3)
    gops = _to(ops, cuda)
    with pytest.raises(ValueError, match="float32"):
        tfl.flash_fwd_hf(vw=vw.to(cuda).double(), **gops)
    with pytest.raises(ValueError, match="on cuda"):
        tfl.flash_fwd_hf(vw=vw, **gops)                 # vw on the CPU
    with pytest.raises(ValueError, match="value width"):
        tfl.flash_fwd_hf(vw=torch.zeros(1, 2, 32, 65, device=cuda), **gops)
    gargs = [t.to(cuda) if torch.is_tensor(t) else t
             for t in _bwd_args(ops, vw, guard_rows=0)]
    for fn in (tfl.flash_bwd_q_hf, tfl.flash_bwd_k_hf):
        bad = list(gargs)
        bad[10] = gargs[10][..., :4].contiguous()      # g narrower than vw
        with pytest.raises(ValueError, match="g has shape"):
            fn(*bad)
        bad[10] = gargs[10].double()
        with pytest.raises(ValueError, match="float32"):
            fn(*bad)
        bad[10] = gargs[10].cpu()
        with pytest.raises(ValueError, match="on cuda"):
            fn(*bad)
        with pytest.raises(RuntimeError, match="not differentiable"):
            fn(*gargs[:10], gargs[10].clone().requires_grad_(), *gargs[11:])


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
@pytest.mark.parametrize("setting,options,launches", [
    ("fold", dict(head_fold=True), dict(flash_fwd_hf=2, colstat=2,
                                        flash_bwd_q_hf=2, flash_bwd_k_hf=2)),
    ("r4", dict(flash_need_heads=False),
     dict(flash_fwd=1, flash_bwd_q=1, flash_bwd_k=1, modulation_fwd=1,
          modulation_bwd=1))])
def test_cuda_settings_step_and_predictor_match_cpu(cuda, monkeypatch,
                                                    setting, options,
                                                    launches):
    """The small SBM model under the "fold" and "r4" settings: one
    training step on CUDA against the CPU with exact launches and no plain
    version on a CUDA tensor, then both served from the stepped weights."""
    graphs = _graphs(3)
    batch = collate_graphs(graphs[:2], max_nodes=64, node_labels=True)
    cpu_model = DiffGraphTransformerGenGCNSBM(**_SMALL, **options,
                                              device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    cfg = TrainConfig(regularization=0.1, sign_flip=False)
    loss_cpu = Trainer(cpu_model, cfg).step(batch)
    wrappers = dict(flash_fwd=tfl.flash_fwd, flash_bwd_q=tfl.flash_bwd_q,
                    flash_bwd_k=tfl.flash_bwd_k, flash_fwd_hf=tfl.flash_fwd_hf,
                    flash_bwd_q_hf=tfl.flash_bwd_q_hf,
                    flash_bwd_k_hf=tfl.flash_bwd_k_hf, colstat=tcs.colstat,
                    modulation_fwd=tmod.modulation_fwd,
                    modulation_bwd=tmod.modulation_bwd)
    before = {k: f.launches for k, f in wrappers.items()}

    def refuse(*_a, **_k):
        raise AssertionError("plain version called on a CUDA tensor")

    with monkeypatch.context() as m:
        for mod, name in ((tfl, "flash_fwd_plain"), (tfl, "flash_bwd_q_plain"),
                          (tfl, "flash_bwd_k_plain"), (tcs, "colstat_plain"),
                          (tmod, "modulation_fwd_plain"),
                          (tmod, "modulation_bwd_plain")):
            m.setattr(mod, name, refuse)
        loss_gpu = Trainer(gpu_model, cfg).step(batch.to(cuda))
    assert {k: f.launches - before[k] for k, f in wrappers.items()} == {
        **dict.fromkeys(wrappers, 0), **launches}, setting
    np.testing.assert_allclose(float(loss_gpu), float(loss_cpu), rtol=1e-4)
    want = dict(cpu_model.named_parameters())
    for name, p in gpu_model.named_parameters():
        np.testing.assert_allclose(p.grad.cpu().numpy(),
                                   want[name].grad.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    cpu_model.load_state_dict(gpu_model.state_dict())
    kw = dict(max_batch=2, node_level=True,
              collate_kwargs={"max_nodes": 64, "node_labels": True})
    got = Predictor(gpu_model, **kw).predict(graphs)
    ref = Predictor(cpu_model, device="cpu", **kw).predict(graphs)
    for g, w in zip(got, ref):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


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


# ------------------------------------------------------------- fused MLP

def _mlp_inputs(seed, r, din, f, dout):
    """chip_smoke's fused-MLP operands (dyadic x, w1 and b1, so that the
    relu takes the same branch as in cuBLAS) on the CPU, with a cotangent
    of scale 0.05: these rows are at most 10,007."""
    return mlp_inputs(seed, r, din, f, dout, "cpu", g_scale=0.05)


@pytest.mark.cuda
@pytest.mark.parametrize("r,din,f,dout,rate", [
    (4096, 8, 2048, 8, 0.0), (4096, 8, 2048, 8, 0.1),
    (10007, 8, 2048, 8, 0.1), (257, 3, 100, 5, 0.3), (300, 16, 512, 16, 0.1),
    (64, 40, 70, 64, 0.0), (1, 8, 520, 8, 0.1), (31, 8, 520, 8, 0.0),
    (10007, 8, 520, 8, 0.0), (31, 16, 520, 16, 0.1), (1, 32, 2048, 32, 0.0),
    (10007, 32, 520, 32, 0.1), (300, 64, 520, 64, 0.1),
    (31, 64, 300, 64, 0.0)])
def test_cuda_fused_mlp_matches_plain(cuda, r, din, f, dout, rate):
    args = _mlp_inputs(3, r, din, f, dout)
    x, w1, b1, w2, b2, g = args
    gargs = [t.to(cuda) for t in args]
    before = tfm.fused_mlp_fwd.launches, tfm.fused_mlp_bwd.launches
    with torch.no_grad():
        got = tfm.fused_mlp_fwd(*gargs[:5], rate, 17)
        got_b = tfm.fused_mlp_bwd(*gargs[:4], gargs[5], rate, 17)
        again = tfm.fused_mlp_bwd(*gargs[:4], gargs[5], rate, 17)
    torch.cuda.synchronize()
    _close([got], [tfm.fused_mlp_plain(x, w1, b1, w2, b2, rate, 17)])
    _close(got_b, tfm.fused_mlp_bwd_plain(x, w1, b1, w2, g, rate, 17))
    # no atomics: the weight gradients are bit-identical run to run
    assert all(torch.equal(a, b) for a, b in zip(got_b, again))
    assert (tfm.fused_mlp_fwd.launches, tfm.fused_mlp_bwd.launches) == (
        before[0] + 1, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("r,din,f,dout,rate", [
    (4096, 8, 2048, 8, 0.0), (4096, 8, 2048, 8, 0.1),
    (10007, 16, 2048, 16, 0.1), (300, 20, 520, 8, 0.0)])
def test_cuda_fused_mlp_fwd_float64_and_bits(cuda, r, din, f, dout, rate):
    """The forward's y: two runs bit-identical, and its error from a
    float64 run of the plain version within 2x the CPU float32 route's
    (chip_smoke.FUSED_CPU32_FACTOR), one slab (d 8) and two or more (d 16
    and 20 at F = 2048 and 520)."""
    x, w1, b1, w2, b2, _ = _mlp_inputs(5, r, din, f, dout)
    with torch.no_grad():
        got = tfm.fused_mlp_fwd(*(t.to(cuda) for t in (x, w1, b1, w2, b2)),
                                rate, 17)
        again = tfm.fused_mlp_fwd(*(t.to(cuda) for t in (x, w1, b1, w2,
                                                         b2)), rate, 17)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    cpu = tfm.fused_mlp_plain(x, w1, b1, w2, b2, rate, 17)
    want = tfm.fused_mlp_plain(*(t.double() for t in (x, w1, b1, w2, b2)),
                               rate, 17)
    e_k = float((got.cpu().double() - want).abs().max())
    e_c = float((cpu.double() - want).abs().max())
    assert e_k <= FUSED_CPU32_FACTOR * e_c, (e_k, e_c)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_cuda_fused_mlp_masks_bit_equal_plain(cuda, rate):
    fwd, bwd = mlp_masks(cuda, 1234, rate, rows=64)
    want = tfm.dropout_keep(1234, 64, 64, rate)
    assert torch.equal(fwd.cpu(), want) and torch.equal(bwd.cpu(), want)
    assert 0 < int(want.sum()) < want.numel()


@pytest.mark.cuda
def test_cuda_fused_mlp_never_takes_the_plain_route(cuda, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("plain version called on a CUDA tensor")

    monkeypatch.setattr(tfm, "fused_mlp_plain", refuse)
    monkeypatch.setattr(tfm, "fused_mlp_bwd_plain", refuse)
    x, w1, b1, w2, b2, _ = (t.to(cuda) for t in
                            _mlp_inputs(4, 100, 8, 256, 8))
    ws = [t.requires_grad_() for t in (w1, b1, w2, b2)]
    before = tfm.fused_mlp_fwd.launches, tfm.fused_mlp_bwd.launches
    tfm.fused_mlp(x.requires_grad_(), *ws, dropout_rate=0.1,
                  seed=2).sum().backward()
    assert (tfm.fused_mlp_fwd.launches, tfm.fused_mlp_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(t.grad is not None for t in (x, *ws))
    with pytest.raises(ValueError, match="contiguous"):
        tfm.fused_mlp_fwd(x.detach().T.contiguous().T, *(
            t.detach() for t in ws))
    with pytest.raises(RuntimeError, match="not differentiable"):
        tfm.fused_mlp_fwd(x, *ws)


_SAN = dict(num_atom_type=28, num_bond_type=4, hidden_dim=16, out_dim=16,
            n_heads=2, n_layers=2, lpe_dim=4, lpe_heads=2, lpe_layers=2,
            filter_order=3, seed=5)


def _zinc(n_graphs):
    graphs = zinc_categorical_dataset(seed=2, n_graphs=n_graphs)
    return apply_laplace_decomp(graphs, 10)


@pytest.mark.cuda
def test_cuda_san_step_and_predictor_match_cpu(cuda):
    graphs = _zinc(6)
    batch = collate_graphs(graphs[:4], max_nodes=32)
    cpu_model = SANNodeSpectra(**_SAN, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    cfg = TrainConfig(task="graph_reg", sign_flip=False)
    before = tfm.fused_mlp_fwd.launches, tfm.fused_mlp_bwd.launches
    loss_gpu = Trainer(gpu_model, cfg).step(batch.to(cuda))
    assert (tfm.fused_mlp_fwd.launches - before[0],
            tfm.fused_mlp_bwd.launches - before[1]) == (2, 2)
    loss_cpu = Trainer(cpu_model, cfg).step(batch)
    np.testing.assert_allclose(float(loss_gpu), float(loss_cpu), rtol=1e-4)
    want = dict(cpu_model.named_parameters())
    for name, p in gpu_model.named_parameters():
        scale = float(want[name].grad.abs().max()) + 1e-12
        err = float((p.grad.cpu() - want[name].grad).abs().max())
        assert err <= 1e-3 * scale + 1e-6, name
    # both served from the CUDA model's stepped weights and statistics
    cpu_model.load_state_dict(gpu_model.state_dict())
    kw = dict(max_batch=4, collate_kwargs={"max_nodes": 32})
    got = Predictor(gpu_model, **kw).predict(graphs)
    ref = Predictor(cpu_model, device="cpu", **kw).predict(graphs)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


# ----------------------------------------------- the LPE tier's shapes

@pytest.mark.cuda
@pytest.mark.parametrize("r,din,rate,slabs", [
    (PATTERN_ROWS, 16, 0.0, 2), (PATTERN_ROWS, 16, 0.1, 2),
    (EDGE_ROWS, 8, 0.1, 1)], ids=["pattern-rate0", "pattern", "edge-pairs"])
def test_cuda_fused_mlp_lpe_shapes_match_plain(cuda, r, din, rate, slabs):
    """The PATTERN eigen-PE head at width 16 (F = 2048 in two forward
    slabs: per-slab partials and the finishing launch) and the
    SAN_EdgeLPE pair head's B*N*N*m rows, against the plain versions run
    on the card (the hidden field of the pair head is 3.8 GB), at
    chip_smoke's cotangent scale for R rows (`mlp_g_scale`)."""
    x, w1, b1, w2, b2, g = mlp_inputs(r + 2048, r, din, 2048, din, cuda,
                                      g_scale=mlp_g_scale(r))
    assert tfm.fwd_slabs(din, 2048, din) == slabs
    before = tfm.fused_mlp_fwd.launches, tfm.fused_mlp_bwd.launches
    with torch.no_grad():
        got = tfm.fused_mlp_fwd(x, w1, b1, w2, b2, rate, 23)
        again = tfm.fused_mlp_fwd(x, w1, b1, w2, b2, rate, 23)
        got_b = tfm.fused_mlp_bwd(x, w1, b1, w2, g, rate, 23)
        assert torch.equal(got, again)
        del again
        want = tfm.fused_mlp_plain(x, w1, b1, w2, b2, rate, 23)
        torch.testing.assert_close(got, want, **TOL)
        del want
        for k, w in zip(got_b, tfm.fused_mlp_bwd_plain(x, w1, b1, w2, g,
                                                       rate, 23)):
            torch.testing.assert_close(k, w, **TOL)
    assert (tfm.fused_mlp_fwd.launches, tfm.fused_mlp_bwd.launches) == (
        before[0] + 2, before[1] + 1)


def _lpe_batch(n_graphs=4):
    graphs = zinc_categorical_dataset(seed=6, n_graphs=n_graphs)
    apply_laplace_decomp(graphs, 10)
    return collate_graphs(graphs, max_nodes=32)


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["SANNet", "GATFeTANet"])
def test_cuda_dropout_masks_match_cpu(cuda, net):
    """One seed draws the same dropout masks on the CPU and on the card:
    the hash mask itself bit for bit, and a train-mode step of a net with
    layer, input (and the GAT's attention) dropout 0.2 and the eigen-PE
    dropout 0.1 gives the CPU's loss and gradients."""
    gen = lambda: torch.Generator().manual_seed(3)
    ones = torch.ones(1000, 24)
    assert torch.equal(hash_dropout(ones, 0.2, gen()) != 0,
                       (hash_dropout(ones.to(cuda), 0.2, gen()) != 0).cpu())
    if net == "SANNet":
        cpu_model = SANNet(num_atom_type=28, num_bond_type=4, lpe="edge",
                           hidden_dim=16, out_dim=16, n_heads=4, n_layers=2,
                           lpe_dim=4, dropout=0.2, in_feat_dropout=0.2,
                           device="cpu")
    else:
        cpu_model = GATFeTANet(num_atom_type=28, hidden_dim=4, out_dim=16,
                               num_heads=4, n_layers=2, dropout=0.2,
                               in_feat_dropout=0.2, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    batch = _lpe_batch()
    cfg = TrainConfig(task="graph_reg", sign_flip=True, seed=4)
    loss_gpu = Trainer(gpu_model, cfg).step(batch.to(cuda))
    loss_cpu = Trainer(cpu_model, cfg).step(batch)
    np.testing.assert_allclose(float(loss_gpu), float(loss_cpu), rtol=1e-4)
    want = dict(cpu_model.named_parameters())
    for name, p in gpu_model.named_parameters():
        scale = float(want[name].grad.abs().max()) + 1e-12
        err = float((p.grad.cpu() - want[name].grad).abs().max())
        assert err <= 1e-3 * scale + 1e-6, name


# ------------------------------------------- modulation and fused attention

def _mod_inputs(seed, b, h, n, pad, with_mod):
    """Scores, pe, degree, float mask and a cotangent on the CPU; pe is 0
    on the first 3 rows of graph 1 (the |denom| <= 1e-9 branch)."""
    ops, _ = _ops(seed, b, h, n, 8, 8, pad, with_mod)
    if with_mod:
        ops["pe"][1, :3] = 0.0
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return f(b, h, n, n), ops["pe"], ops["deg"], ops["mask"], f(b, h, n, n)


# (B, H, N, padding, pe and deg, the last graph all masked): the kernels'
# team geometries (T = 1, 8, 16, 32, 128 threads a row, V = 1 and 4 groups
# a thread; 4-byte loads at N of 1, 17, 129 and 300), H of 1, 3 and 8, a
# graph with no real node
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,pad,with_mod,dead", [
    (3, 8, 48, 7, True, False), (2, 8, 300, 11, False, False),
    (2, 8, 1, 0, True, False), (2, 1, 17, 3, True, False),
    (3, 3, 129, 5, True, True), (2, 8, 2048, 100, True, False),
    (2, 3, 2048, 60, False, True)])
def test_cuda_modulation_matches_plain(cuda, b, h, n, pad, with_mod, dead):
    args = _mod_inputs(10, b, h, n, pad, with_mod)
    if dead:
        for t in args[1:4]:
            if t is not None:
                t[-1] = 0.0
    gargs = [None if t is None else t.to(cuda) for t in args]
    before = tmod.modulation_fwd.launches, tmod.modulation_bwd.launches
    got = tmod.modulation_fwd(*gargs[:4])
    got_b = tmod.modulation_bwd(*gargs)
    again = tmod.modulation_bwd(*gargs)
    torch.cuda.synchronize()
    _close([got, got_b], [tmod.modulation_fwd_plain(*args[:4]),
                          tmod.modulation_bwd_plain(*args)])
    assert torch.equal(got_b, again)
    masked = masked_cells(args[3]).expand(b, h, n, n)
    for out in (got, got_b):
        assert bool((out.cpu()[masked] == 0).all())
    assert (tmod.modulation_fwd.launches, tmod.modulation_bwd.launches) == (
        before[0] + 1, before[1] + 2)


# (B, H, N, padding, D, pe and deg): the ZINC widths at H = 8 (clusters
# of 8); H = 1, 3 and 12 (clusters of 1, 3 and 6, two heads a CTA) at N of
# 1, 16, 17 (past one strip), 48 and 128 (the largest), D = 20 (the K
# edge); guard rows wherever pe is given
@pytest.mark.cuda
@pytest.mark.parametrize("b,h,n,pad,d,with_mod", [
    (3, 8, 48, 7, 64, True), (2, 8, 128, 0, 16, False),
    (2, 8, 77, 5, 40, True), (2, 1, 48, 5, 64, True), (2, 3, 17, 2, 20, True),
    (2, 12, 128, 9, 64, True), (2, 1, 1, 0, 20, True),
    (2, 3, 16, 0, 64, True), (2, 12, 17, 3, 20, True),
    (2, 3, 128, 17, 20, True), (2, 12, 48, 7, 20, True)])
def test_cuda_fused_attention_matches_plain(cuda, b, h, n, pad, d, with_mod):
    ops, vw = _ops(11, b, h, n, d, d, pad, with_mod)
    if with_mod:
        ops["pe"][1, :3] = 0.0
    g = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (b, n, d)).astype(np.float32))
    gops = _to(ops, cuda)
    before = tfa.fused_attn_fwd.launches, tfa.fused_attn_bwd.launches
    got = tfa.fused_attn_fwd(vw=vw.to(cuda), **gops)
    got_b = tfa.fused_attn_bwd(vw=vw.to(cuda), g=g.to(cuda), **gops)
    again = tfa.fused_attn_bwd(vw=vw.to(cuda), g=g.to(cuda), **gops)
    torch.cuda.synchronize()
    _close([got], [tfa.fused_attn_fwd_plain(vw=vw, **ops)])
    _close(got_b, tfa.fused_attn_bwd_plain(vw=vw, g=g, **ops))
    # no atomics: the column and head sums are bit-identical run to run
    assert all(torch.equal(x, y) for x, y in zip(got_b, again))
    assert (tfa.fused_attn_fwd.launches, tfa.fused_attn_bwd.launches) == (
        before[0] + 1, before[1] + 2)


@pytest.mark.cuda
def test_cuda_fused_attention_clusters_as_cluster_size(cuda):
    """The kernels' launcher groups a graph's heads into as many CTAs as
    the wrapper's `cluster_size` says, for H = 1 .. 16."""
    lib, _ = tfa._kernel("fwd")
    assert [lib.feta_fused_attn_cluster(h) for h in range(1, 17)] == [
        tfa.cluster_size(h) for h in range(1, 17)]


@pytest.mark.cuda
def test_cuda_modulation_and_fused_wrappers_reject(cuda):
    scores, pe, deg, mask, g = (t.to(cuda) for t in
                                _mod_inputs(13, 2, 2, 16, 3, True))
    with pytest.raises(ValueError, match="float32"):
        tmod.modulation_fwd(scores.double(), pe, deg, mask)
    with pytest.raises(ValueError, match="contiguous"):
        tmod.modulation_bwd(scores, pe, deg, mask, g.transpose(2, 3))
    with pytest.raises(RuntimeError, match="not differentiable"):
        tmod.modulation_fwd(scores.requires_grad_(), pe, deg, mask)
    ops, vw = _ops(14, 1, 2, tfa.MAX_NODES + 1, 16, 16, 0, True)
    gops, vw = _to(ops, cuda), vw.to(cuda)
    with pytest.raises(ValueError, match="N=129 > 128"):
        tfa.fused_attn_fwd(vw=vw, **gops)
    ops, vw = _ops(15, 1, 2, 32, 16, 16, 0, True)
    gops, vw = _to(ops, cuda), vw.to(cuda)
    with pytest.raises(ValueError, match="float32"):
        tfa.fused_attn_fwd(vw=vw.double(), **gops)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.fused_attn_bwd(vw=vw, g=torch.zeros(1, 16, 32, device=cuda)
                           .transpose(1, 2), **gops)
    wide, vw = _ops(16, 1, 2, 32, 72, 72, 0, True)
    with pytest.raises(ValueError, match="D=72 > 64"):
        tfa.fused_attn_fwd(vw=vw.to(cuda), **_to(wide, cuda))


@pytest.mark.cuda
def test_cuda_modulation_and_fused_never_take_the_plain_route(
        cuda, monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("plain version called on a CUDA tensor")

    for mod, names in ((tmod, ("modulation_fwd_plain",
                               "modulation_bwd_plain")),
                       (tfa, ("fused_attn_fwd_plain",
                              "fused_attn_bwd_plain"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    scores, pe, deg, mask, g = (t.to(cuda) for t in
                                _mod_inputs(17, 2, 2, 16, 3, True))
    s = scores.requires_grad_()
    tmod.fused_modulated_attention(s, mask > 0, pe=pe, degree=deg).backward(g)
    rng = np.random.default_rng(18)
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)).to(cuda).requires_grad_()
    args = (f(2, 2, 16, 8), f(2, 16, 8), f(2, 16, 2), f(2, 16, 2), f(2),
            f(2, 2, 16, 8))
    before = tfa.fused_attn_fwd.launches, tfa.fused_attn_bwd.launches
    tfa.fused_graphit_attention(*args, mask > 0, pe=pe,
                                degree=deg).sum().backward()
    assert (tfa.fused_attn_fwd.launches, tfa.fused_attn_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert s.grad is not None and all(a.grad is not None for a in args)


_ZINC = dict(in_size=28, nb_class=1, d_model=16, nb_heads=2,
             dim_feedforward=32, dropout=0.0, nb_layers=2, batch_norm=True,
             lap_pos_enc=True, lap_pos_enc_dim=8, filter_order=3, seed=5)


@pytest.mark.cuda
@pytest.mark.parametrize("impl,launches", [
    ("modulation", (2, 2, 0, 0)), ("fused", (1, 1, 1, 1))])
def test_cuda_zinc_step_and_predictor_match_cpu(cuda, impl, launches):
    graphs = zinc_like_dataset(seed=4, n_graphs=6)
    DiffusionEncoding(beta=1.0).apply_to(graphs)
    LapEncoding(8).apply_to(graphs)
    batch = collate_graphs(graphs[:4], max_nodes=48)
    cpu_model = DiffGraphTransformerGenGCN(**_ZINC, attention_impl=impl,
                                           device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    cfg = TrainConfig(task="graph_reg", regularization=0.1, sign_flip=False)
    counts = lambda: (tmod.modulation_fwd.launches,
                      tmod.modulation_bwd.launches,
                      tfa.fused_attn_fwd.launches, tfa.fused_attn_bwd.launches)
    before = counts()
    loss_gpu = Trainer(gpu_model, cfg).step(batch.to(cuda))
    assert tuple(a - b for a, b in zip(counts(), before)) == launches
    loss_cpu = Trainer(cpu_model, cfg).step(batch)
    np.testing.assert_allclose(float(loss_gpu), float(loss_cpu), rtol=1e-4)
    want = dict(cpu_model.named_parameters())
    for name, p in gpu_model.named_parameters():
        np.testing.assert_allclose(p.grad.cpu().numpy(),
                                   want[name].grad.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    cpu_model.load_state_dict(gpu_model.state_dict())
    kw = dict(max_batch=4, collate_kwargs={"max_nodes": 48})
    got = Predictor(gpu_model, **kw).predict(graphs)
    ref = Predictor(cpu_model, device="cpu", **kw).predict(graphs)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_molhiv_step_and_predictor_match_cpu(cuda):
    """The molhiv model at its CLI width (d_model 128, 8 heads; 2 layers)
    on the flash route: one binary_graph step's loss and gradients and the
    served logits on CUDA against the CPU, 2 + 1 + 2 + 2 launches a step
    (the flash forward on both layers, colstat twice on the filtered one,
    both backward passes on both)."""
    graphs = ogb_like_dataset(seed=3, n_graphs=6)
    batch = collate_graphs(graphs[:4], max_nodes=32)
    cpu_model = DiffGraphTransformerGenGCNMolHiv(
        nb_class=1, d_model=128, nb_heads=8, dim_feedforward=256,
        dropout=0.0, nb_layers=2, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    cfg = TrainConfig(task="binary_graph", regularization=0.1,
                      sign_flip=False)
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
    cpu_model.load_state_dict(gpu_model.state_dict())
    kw = dict(max_batch=4, collate_kwargs={"max_nodes": 32})
    got = Predictor(gpu_model, **kw).predict(graphs)
    ref = Predictor(cpu_model, device="cpu", **kw).predict(graphs)
    assert got.shape == (6,)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------ the LSPE nets

_LSPE = dict(num_atom_type=28, num_bond_type=4, hidden_dim=20, out_dim=20,
             n_layers=2, pos_enc_dim=8)
_LSPE_NETS = {
    "graphit-spectra": (GraphiTSpectraNet, dict(n_heads=4,
                                                adaptive_edge_pe=True)),
    "graphit-field": (GraphiTSpectraNet, dict(n_heads=4, spectra=False,
                                              typed_edges=False)),
    "san-lspe": (SANLSPENet, dict(n_heads=4, gamma=0.2)),
    "gatedgcn": (GatedGCNLSPENet, {}),
    "gatedgcn-sparse": (GatedGCNLSPENet, {}),
    "pna": (PNALSPENet, dict(towers=2, edge_feat=True, edge_dim=6,
                             gru=True, avg_d_log=1.2)),
    "pna-sparse": (PNALSPENet, dict(towers=2, edge_feat=True,
                                    sparse_edges=True, avg_d_log=1.2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("net", sorted(_LSPE_NETS))
def test_cuda_lspe_nets_match_cpu(cuda, net):
    """A train-mode step (batch statistics) on CUDA against the CPU's from
    the same weights, then both serving the stepped weights; COO batches
    for the sparse runs; no kernel counter moves (these nets run none)."""
    cls, kw = _LSPE_NETS[net]
    graphs = zinc_categorical_dataset(seed=4, n_graphs=6)
    apply_rwpe(graphs, 8)
    PStepRWEncoding(p=4, beta=0.25, normalization="sym").apply_to(graphs)
    collate = dict(max_nodes=32, with_coo=net.endswith("sparse"))
    cpu_model = cls(**_LSPE, **kw, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    cfg = TrainConfig(task="graph_reg", sign_flip=False)
    batch = collate_graphs(graphs[:4], **collate)
    kernels = (tfl.flash_fwd, tfl.flash_bwd_q, tfl.flash_bwd_k, tcs.colstat,
               tfl.flash_fwd_hf, tfl.flash_bwd_q_hf, tfl.flash_bwd_k_hf,
               tfm.fused_mlp_fwd, tfm.fused_mlp_bwd, tmod.modulation_fwd,
               tmod.modulation_bwd, tfa.fused_attn_fwd, tfa.fused_attn_bwd)
    before = [k.launches for k in kernels]
    loss_gpu = Trainer(gpu_model, cfg).step(batch.to(cuda))
    loss_cpu = Trainer(cpu_model, cfg).step(batch)
    np.testing.assert_allclose(float(loss_gpu), float(loss_cpu), rtol=1e-4)
    want = dict(cpu_model.named_parameters())
    for name, p in gpu_model.named_parameters():
        if want[name].grad is None:
            assert p.grad is None, name
            continue
        scale = float(want[name].grad.abs().max()) + 1e-12
        err = float((p.grad.cpu() - want[name].grad).abs().max())
        assert err <= 1e-3 * scale + 1e-6, name
    cpu_model.load_state_dict(gpu_model.state_dict())
    kw = dict(max_batch=4, collate_kwargs=collate)
    got = Predictor(gpu_model, **kw).predict(graphs)
    ref = Predictor(cpu_model, device="cpu", **kw).predict(graphs)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    assert [k.launches for k in kernels] == before


# ------------------------------------- the GraphiT baselines, the options

@pytest.mark.cuda
def test_cuda_unmodulated_kernels_match_plain_at_the_zinc_batch(cuda):
    """pe and deg absent (nullptr: the vanilla GraphTransformer's
    attention) at B=128, N=48: the flash forward and both backward passes
    and the fused pair against their plain versions (ones in place of pe
    and deg), two runs of each bit-identical."""
    ops, vw = _ops(21, 128, 8, 48, 64, 64, 11, with_mod=False)
    gops, gvw = _to(ops, cuda), vw.to(cuda)
    with torch.no_grad():
        got = tfl.flash_fwd(vw=gvw, **gops)
        assert all(torch.equal(a, b) for a, b in zip(
            got, tfl.flash_fwd(vw=gvw, **gops)))
        want = tfl.flash_fwd_plain(vw=vw, **ops)
        _close(got, want)
        g = torch.from_numpy(np.random.default_rng(22).standard_normal(
            tuple(want[0].shape)).astype(np.float32))
        outh, m, se, su = want
        args = (ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"], vw,
                None, None, ops["mask"], ops["inv_sqrt"], g, m,
                *bwd_row_constants(g, outh, se, su, ops["mask"]))
        gargs = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in args)
        for kernel, plain in ((tfl.flash_bwd_q, tfl.flash_bwd_q_plain),
                              (tfl.flash_bwd_k, tfl.flash_bwd_k_plain)):
            got = kernel(*gargs)
            assert all(torch.equal(a, b) for a, b in zip(got,
                                                         kernel(*gargs)))
            _close(got, plain(*args))
        gf = torch.from_numpy(np.random.default_rng(23).standard_normal(
            (128, 48, 64)).astype(np.float32))
        got_f = tfa.fused_attn_fwd(vw=gvw, **gops)
        assert torch.equal(got_f, tfa.fused_attn_fwd(vw=gvw, **gops))
        _close([got_f], [tfa.fused_attn_fwd_plain(vw=vw, **ops)])
        got_b = tfa.fused_attn_bwd(vw=gvw, g=gf.to(cuda), **gops)
        assert all(torch.equal(a, b) for a, b in zip(
            got_b, tfa.fused_attn_bwd(vw=gvw, g=gf.to(cuda), **gops)))
        _close(got_b, tfa.fused_attn_bwd_plain(vw=vw, g=gf, **ops))


_BASE = dict(in_size=28, nb_class=1, d_model=64, nb_heads=8,
             dim_feedforward=128, dropout=0.0, nb_layers=2,
             lap_pos_enc=True, lap_pos_enc_dim=8)


@pytest.mark.cuda
@pytest.mark.parametrize("cls,impl,launches", [
    (GraphTransformer, "flash", (2, 2, 2, 0, 0)),
    (GraphTransformer, "fused", (0, 0, 0, 2, 2)),
    (DiffGraphTransformer, "flash", (2, 2, 2, 0, 0)),
    (DiffGraphTransformerGCN, "fused", (0, 0, 0, 2, 2))])
def test_cuda_graphit_baseline_step_and_predictor_match_cpu(cuda, cls, impl,
                                                            launches):
    """Two-layer baselines on the ZINC batch: one step's loss and
    gradients and the served logits on CUDA against the CPU, and the
    launches of a step (a forward and both backward passes a layer on
    "flash", the fused pair a layer on "fused")."""
    graphs = zinc_like_dataset(seed=4, n_graphs=6)
    DiffusionEncoding(beta=1.0).apply_to(graphs)
    LapEncoding(8).apply_to(graphs)
    batch = collate_graphs(graphs[:4], max_nodes=48)
    kw = (_BASE if cls is GraphTransformer
          else dict(_BASE, batch_norm=True))
    cpu_model = cls(**kw, attention_impl=impl, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    cfg = TrainConfig(task="graph_reg", sign_flip=False)
    counts = lambda: (tfl.flash_fwd.launches, tfl.flash_bwd_q.launches,
                      tfl.flash_bwd_k.launches, tfa.fused_attn_fwd.launches,
                      tfa.fused_attn_bwd.launches)
    before = counts()
    loss_gpu = Trainer(gpu_model, cfg).step(batch.to(cuda))
    assert tuple(a - b for a, b in zip(counts(), before)) == launches
    loss_cpu = Trainer(cpu_model, cfg).step(batch)
    np.testing.assert_allclose(float(loss_gpu), float(loss_cpu), rtol=1e-4)
    want = dict(cpu_model.named_parameters())
    for name, p in gpu_model.named_parameters():
        np.testing.assert_allclose(p.grad.cpu().numpy(),
                                   want[name].grad.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    cpu_model.load_state_dict(gpu_model.state_dict())
    pkw = dict(max_batch=4, collate_kwargs={"max_nodes": 48})
    got = Predictor(gpu_model, **pkw).predict(graphs)
    ref = Predictor(cpu_model, device="cpu", **pkw).predict(graphs)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [dict(), dict(last_layer_filter=False),
                                  dict(gnn_type="ARMAConvDynamic")])
def test_cuda_remat_step_is_bit_equal(cuda, opts):
    """The FeTA ZINC model (2 layers, dropout 0.1) with `remat`: one step
    on CUDA bit-equal to the step without it from the same weights and
    global seed (loss, gradients, updated weights, batch-norm statistics),
    with one more forward's launches (a flash forward a layer, two colstat
    launches a filtered layer)."""
    graphs = zinc_like_dataset(seed=5, n_graphs=4)
    DiffusionEncoding(beta=1.0).apply_to(graphs)
    LapEncoding(8).apply_to(graphs)
    batch = collate_graphs(graphs, max_nodes=48).to(cuda)
    base = DiffGraphTransformerGenGCN(**_ZINC, **opts, device=cuda)
    base.encoder.layers.apply(lambda m: setattr(m, "p", 0.1)
                              if isinstance(m, torch.nn.Dropout) else None)
    runs = []
    for remat in (False, True):
        model = copy.deepcopy(base)
        model.encoder.remat = remat
        torch.manual_seed(3)
        before = tfl.flash_fwd.launches, tcs.colstat.launches
        loss = Trainer(model, TrainConfig(task="graph_reg",
                                          sign_flip=False)).step(batch)
        runs.append((loss, model, (tfl.flash_fwd.launches - before[0],
                                   tcs.colstat.launches - before[1])))
    (l0, m0, c0), (l1, m1, c1) = runs
    assert torch.equal(l0, l1)
    for (name, p0), p1 in zip(m0.named_parameters(), m1.parameters()):
        assert torch.equal(p0.grad, p1.grad) and torch.equal(p0, p1), name
    for (name, b0), b1 in zip(m0.named_buffers(), m1.buffers()):
        assert torch.equal(b0, b1), name
    layers = _ZINC["nb_layers"]
    filtered = layers if opts.get("last_layer_filter") is False else 1
    assert (c1[0] - c0[0], c1[1] - c0[1]) == (layers, 2 * filtered)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(attention_impl="fused"),
                                dict(head_fold=True)])
def test_cuda_molhiv_baseline_refuses_width_128(cuda, kw):
    """The fused pair and the folded kernels take D <= 64: the molhiv
    baseline at d_model 128 raises on them, with no fallback and no
    launch."""
    graphs = ogb_like_dataset(seed=3, n_graphs=4)
    batch = collate_graphs(graphs, max_nodes=32).to(cuda)
    model = DiffGraphTransformerMolHiv(
        d_model=128, nb_heads=8, dim_feedforward=256, dropout=0.0,
        nb_layers=2, device=cuda, **kw).eval()
    before = (tfa.fused_attn_fwd.launches, tfl.flash_fwd_hf.launches,
              tfl.flash_fwd.launches)
    with torch.no_grad(), pytest.raises(ValueError, match="64"):
        model(batch)
    assert (tfa.fused_attn_fwd.launches, tfl.flash_fwd_hf.launches,
            tfl.flash_fwd.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("normalization", ["rw", None])
def test_cuda_lambda_max_within_the_cpu_float32_error(cuda, normalization):
    """The power iteration's lambda_max on the card in float32 at the ZINC
    batch: each graph's error from float64 within 2x the CPU float32
    route's error on that graph plus two float32 ulps of its value, with
    no host sync."""
    from feta_tmlr_tpu_torch.ops.lambda_max import laplacian_lambda_max
    graphs = zinc_like_dataset(seed=6, n_graphs=128)
    batch = collate_graphs(graphs, max_nodes=48)
    want = laplacian_lambda_max(batch.adj.double(), batch.node_mask,
                                normalization)
    cpu32 = laplacian_lambda_max(batch.adj, batch.node_mask, normalization)
    gb = batch.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = laplacian_lambda_max(gb.adj, gb.node_mask, normalization)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    err = (got.cpu().double() - want).abs().numpy()
    bound = (2 * (cpu32.double() - want).abs().numpy()
             + 2 * np.spacing(want.abs().numpy().astype(np.float32)))
    over = np.flatnonzero(err > bound)
    assert over.size == 0, (over, err[over], bound[over])


# ------------------------------------------------------ packed batches

_ALL_KERNELS = (tfl.flash_fwd, tcs.colstat, tfl.flash_bwd_q, tfl.flash_bwd_k,
                tfl.flash_fwd_hf, tfl.flash_bwd_q_hf, tfl.flash_bwd_k_hf,
                tfm.fused_mlp_fwd, tfm.fused_mlp_bwd, tmod.modulation_fwd,
                tmod.modulation_bwd, tfa.fused_attn_fwd, tfa.fused_attn_bwd)


def _launch_counts():
    return tuple(k.launches for k in _ALL_KERNELS)


def _packed_graphs(n=12):
    graphs = zinc_like_dataset(seed=6, n_graphs=n)
    DiffusionEncoding(beta=1.0).apply_to(graphs)
    LapEncoding(8).apply_to(graphs)
    return graphs


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["flash", "fused"])
def test_cuda_packed_step_and_forward_match_cpu(cuda, impl):
    """The packed ZINC model (2 layers, rows of 128) on CUDA against the
    CPU from the same weights: one train-mode step's loss (rtol 1e-4) and
    gradients (rtol 1e-3 / atol 1e-5), then the eval logits (rtol 1e-4 /
    atol 1e-4); no kernel launched, whatever `attention_impl` says (packed
    rows take the plain pair-masked chain)."""
    batch = pack_graphs(_packed_graphs(), row_len=128)
    cpu_model = PackedDiffGraphTransformerGenGCN(**_ZINC, device="cpu")
    for layer in cpu_model.encoder.layers:
        layer.attention_impl = impl
    gpu_model = copy.deepcopy(cpu_model).to(cuda)
    cfg = TrainConfig(task="graph_reg", regularization=0.1, sign_flip=False)
    before = _launch_counts()
    loss_gpu = Trainer(gpu_model, cfg).step(batch.to(cuda))
    assert _launch_counts() == before
    loss_cpu = Trainer(cpu_model, cfg).step(batch)
    np.testing.assert_allclose(float(loss_gpu), float(loss_cpu), rtol=1e-4)
    want = dict(cpu_model.named_parameters())
    for name, p in gpu_model.named_parameters():
        np.testing.assert_allclose(p.grad.cpu().numpy(),
                                   want[name].grad.numpy(), rtol=1e-3,
                                   atol=1e-5, err_msg=name)
    # the parameters whose gradient is 0 by construction (biases before a
    # batch norm) take Adam steps of +-lr from rounding noise: serve the
    # same weights on both
    cpu_model.load_state_dict(gpu_model.state_dict())
    before = _launch_counts()
    with torch.no_grad():
        got = gpu_model.eval()(batch.to(cuda))[0].cpu().numpy()
        ref = cpu_model.eval()(batch)[0].numpy()
    assert _launch_counts() == before
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_flash_counts_unchanged_without_a_pair_mask(cuda):
    """The unpacked ZINC model on "flash" (pair_mask None) keeps its
    launches: a step 2 + 2 + 2 + 2 (flash forward and both backward passes
    a layer, colstat twice on the filtered one), and its packed twin's
    logits on the same graphs within rtol 1e-4 / atol 1e-4 of its own."""
    graphs = _packed_graphs()
    batch = collate_graphs(graphs, max_nodes=48).to(cuda)
    model = DiffGraphTransformerGenGCN(**_ZINC, device=cuda)
    counts = lambda: (tfl.flash_fwd.launches, tcs.colstat.launches,
                      tfl.flash_bwd_q.launches, tfl.flash_bwd_k.launches)
    before = counts()
    Trainer(model, TrainConfig(task="graph_reg", sign_flip=False)).step(batch)
    assert tuple(a - b for a, b in zip(counts(), before)) == (2, 2, 2, 2)
    packed = PackedDiffGraphTransformerGenGCN(**_ZINC, device=cuda)
    packed.load_state_dict(model.state_dict())
    with torch.no_grad():
        want = model.eval()(batch)[0].cpu().numpy()
        got = packed.eval()(pack_graphs(graphs, row_len=128).to(cuda))[0]
    rows = pack_rows([g.num_nodes for g in graphs], 128)
    got = got.cpu().numpy()
    for r, members in enumerate(rows):
        for slot, gi in enumerate(members):
            np.testing.assert_allclose(got[r, slot], want[gi], rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.cuda
def test_cuda_ogb_atom_encoder_gradient_is_deterministic(cuda):
    """The OGB atom encoder at a molpcba batch's ~7,000 ids a column: two
    backward passes give the same table gradients bit for bit (one-hot
    products; `nn.Embedding`'s backward sums these with atomics on the
    card), within 1e-5 of each table's largest entry of the CPU's (a row
    sums up to ~3,500 products in float32 in another order)."""
    from feta_tmlr_tpu_torch.nn.ogb import OGBAtomEncoder
    graphs = ogb_like_dataset(seed=0, n_graphs=256)
    x = collate_graphs(graphs, max_nodes=27).x
    enc = OGBAtomEncoder(128, generator=torch.Generator().manual_seed(0))
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (256, 27, 128)).astype(np.float32))
    grads = []
    for model, dev in ((copy.deepcopy(enc).to(cuda), cuda),
                       (copy.deepcopy(enc).to(cuda), cuda), (enc, "cpu")):
        (model(x.to(dev)) * w.to(dev)).sum().backward()
        grads.append([getattr(model, n).weight.grad.cpu() for n in
                      model.names])
    for name, a, b, c in zip(enc.names, *grads):
        assert torch.equal(a, b), name
        err = float((a - c).abs().max() / c.abs().max())
        assert err <= 1e-5, f"{name}: {err:.2e} of max |g|"


@pytest.mark.cuda
def test_cuda_one_hot_embedding_gradient_is_deterministic(cuda):
    """`nn/san.py::embedding()`'s tables (OneHotEmbedding) at a batch of
    128 graphs of 32 nodes (4,096 atom ids) and its [B, N, N] bond types
    (131,072 ids): two backward passes give the same table gradients bit
    for bit, within 1e-5 of each table's largest entry of the CPU's."""
    from feta_tmlr_tpu_torch.nn.san import embedding
    g = torch.Generator().manual_seed(0)
    for vocab, shape in ((28, (128, 32)), (4, (128, 32, 32))):
        emb = embedding(vocab, 56, g)
        ids = torch.randint(0, vocab, shape, generator=g, dtype=torch.int32)
        w = torch.randn(*shape, 56, generator=g)
        grads = []
        for model, dev in ((copy.deepcopy(emb).to(cuda), cuda),
                           (copy.deepcopy(emb).to(cuda), cuda),
                           (emb, "cpu")):
            (model(ids.to(dev)) * w.to(dev)).sum().backward()
            grads.append(model.weight.grad.cpu())
        assert torch.equal(grads[0], grads[1]), shape
        err = float((grads[0] - grads[2]).abs().max()
                    / grads[2].abs().max())
        assert err <= 1e-5, f"{shape}: {err:.2e} of max |g|"


@pytest.mark.cuda
def test_cuda_segment_ops_are_deterministic(cuda):
    """segment_sum over 1M unsorted rows into 3,000 segments and
    gather_rows' backward: the same bits in two runs, within 1e-5 of the
    largest entry of the CPU's."""
    from feta_tmlr_tpu_torch.ops.segment import gather_rows, segment_sum
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.standard_normal((1 << 20, 16)).astype(
        np.float32))
    ids = torch.from_numpy(rng.integers(0, 3000, 1 << 20))
    x = torch.from_numpy(rng.standard_normal((3000, 16)).astype(np.float32))
    runs = []
    for dev in (cuda, cuda, "cpu"):
        xs = x.to(dev).requires_grad_(True)
        gather_rows(xs, ids.to(dev)).mul(data.to(dev)).sum().backward()
        runs.append((segment_sum(data.to(dev), ids.to(dev), 3000).cpu(),
                     xs.grad.cpu()))
    for a, b, c in zip(*runs):
        assert torch.equal(a, b)
        assert float((a - c).abs().max() / c.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_gckn_encode_is_deterministic(cuda, monkeypatch):
    """GCKN codes of 16 ZINC-like graphs at paths of 6 nodes: two encodes
    on the card bit-equal, the same bits with blocks of 4,096 path rows,
    and within 1e-4 of the largest code of the CPU's float32 encode."""
    from feta_tmlr_tpu_torch.gckn import layer as glayer
    from feta_tmlr_tpu_torch.gckn.models import GCKNFeature
    from feta_tmlr_tpu_torch.gckn.paths import build_path_batch
    graphs = zinc_like_dataset(seed=0, n_graphs=16)
    model = GCKNFeature.create(28, [32], [6], 0.6, pooling="sum")
    batch = model.unsup_train(graphs, 20000, seed=0)
    encode = lambda dev: np.concatenate(model.encode(graphs, batch,
                                                     device=dev))
    runs = [encode(cuda), encode(cuda)]
    monkeypatch.setattr(glayer, "BLOCK_ROWS", 4096)
    runs += [encode(cuda), encode("cpu")]
    assert np.array_equal(runs[0], runs[1])
    assert np.array_equal(runs[0], runs[2])
    scale = np.abs(runs[3]).max()
    assert np.abs(runs[0] - runs[3]).max() <= 1e-4 * scale
    assert build_path_batch(graphs, 6).path_indices[5].shape[0] > 4096


@pytest.mark.cuda
def test_cuda_gckn_supervised_step_matches_cpu(cuda):
    """A GCKNSupervised step (paths of 4 nodes, hidden 32, sum pooling,
    L1): two runs' gradients bit-equal on the card, each within 1e-3 of
    its largest entry of the CPU's, the loss rtol 1e-5."""
    from feta_tmlr_tpu_torch.gckn.models import GCKNSupervised
    from feta_tmlr_tpu_torch.gckn.paths import build_path_batch
    graphs = zinc_like_dataset(seed=0, n_graphs=32)
    base = GCKNSupervised(28, [32], [4], 1, 0.5, "sum", device="cpu")
    base.unsup_init(graphs, 5000)
    batch = build_path_batch(graphs, 4)
    y = torch.tensor([float(g.y) for g in graphs])
    runs = []
    for dev in (cuda, cuda, "cpu"):
        model = copy.deepcopy(base).to(dev)
        loss = torch.abs(model(batch)[:, 0] - y.to(dev)).mean()
        loss.backward()
        runs.append((loss.item(), {n: p.grad.cpu()
                                   for n, p in model.named_parameters()}))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_allclose(runs[0][0], runs[2][0], rtol=1e-5)
    for name, g in runs[2][1].items():
        assert torch.equal(runs[0][1][name], runs[1][1][name]), name
        err = float((runs[0][1][name] - g).abs().max() / g.abs().max())
        assert err <= 1e-3, f"{name}: {err:.2e}"
