"""The arithmetic of `colstat` and of the fused MLP's backward, emulated on
the CPU.

`csrc/colstat.cu` recomputes the attention of a 64-key block tile by tile
and sums its columns (at D = 20, and at its wide rows' D = 128);
`csrc/fused_mlp.cu`'s backward walks each (slab of hidden units, split of
rows) once on the tensor cores. No card is needed
to check that their arithmetic keeps float32 accuracy: it is emulated here
in torch, step by step in the kernels' order, with the TF32 split of
`test_torch_tf32_split.py` and the batched 3xTF32 k-steps of
`test_torch_fused_tiles.py`. The block geometry is read from the sources.

(a) colstat: the score as the forwards' FMA chain, attn per score as
e * (1/se) * (pe * deg) * (qmask/safe) * kmask, each thread's 4 queries of
a tile into a fresh partial by FMA with wq, the tiles in runs of 8
(`graphit::RunSum`), the 4 lanes of a key row (xor 1, then 2), the query
groups in order. At B=2, H=3, N of 17, 48 and 130 with padded keys and
guard rows (|su/se| <= 1e-9), pe or deg absent, wq absent or given: within
rtol 1e-4 / atol 1e-5 of `colstat_plain` and of float64, the column sums'
mean absolute error from float64 within 2x the CPU float32 route's, and at
N=130 their maximum too. The mean at every N: a case at N=17 holds 102
column sums whose largest errors are 1-2 ulp, so the ratio of two maxima
is decided by one rounding (over 60 seeds of these cases the ratio of
maxima passed 2 once, at 2.08, and the ratio of means stayed at or below
1.29; at N=130 at or below 1.62 and 0.96). `chip_smoke.py` holds the
card's maxima to 2x at N=48 to 2048.

(b) the MLP backward: pre = b1 + W1^T x^T and g W2^T per 8-deep k-step in
3xTF32, the keep bit, hd and dh in the fragments; dW1^T += dh^T x and
dW2 += hd^T g a fresh fragment per 8-row k-step into runs of 64 rows,
then the block's total; db1 a fresh partial per tile of each thread's
rows in order, runs of 8 tiles, then the 4 lanes; db2 by slab 0 per tile,
runs of 8 tiles; dx per warp over its units' k-steps, then the 8 warps in
order; the splits' and the slabs' partials in order, in runs of 8. At R =
300, d 8 and 20, F = 520, dropout 0 and 0.1: each output within rtol 1e-4
/ atol 1e-5 of `fused_mlp_bwd_plain` and of float64, and its error from
float64 within 2x the CPU float32 route's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from feta_tmlr_tpu_torch.ops.kernels import colstat as tcs
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as tfl
from feta_tmlr_tpu_torch.ops.kernels import fused_mlp as tfm
from feta_tmlr_tpu_torch.ops.kernels.common import EPS, NEG_INF
from test_torch_fused_tiles import mma_steps, padded, up, warm_exp  # noqa
from test_torch_tf32_split import RUN_TILES, fma_chain, lane_sum, run_sum

KERNEL_TOL = chip_smoke.KERNEL_TOL          # rtol 1e-4, atol 1e-5
CPU32_FACTOR = 2                            # error over the CPU f32 route's
CSRC = Path(tcs.__file__).resolve().parents[2] / "csrc"


def constant(source, name):
    """An integer `constexpr int name = value;` of a kernel source."""
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def max_err(got, want):
    return float((got.double() - want.double()).abs().max())


def mean_err(got, want):
    return float((got.double() - want.double()).abs().mean())


def f64(args):
    return [a.double() if torch.is_tensor(a) else a for a in args]


# ---------------------------------------------------------------- colstat

def colstat_geometry():
    """(keys per block, query groups, queries a warp, queries per tile)."""
    kt, ek, nq = (constant("colstat.cu", k) for k in ("kKT", "kEK", "kNQ"))
    warps = 256 // 32
    groups = warps // (kt // (8 * ek))
    return kt, groups, 8 * nq, groups * 8 * nq


def colstat_emulated(xa, x, cq, ck, c0, pe, deg, mask, inv_sqrt, m, se, su,
                     wq=None):
    """colstat_kernel's arithmetic in torch: (colsum, diag) [B, H, N]."""
    b, h, n, d = xa.shape
    kt, groups, qw, qt = colstat_geometry()
    nk, nqp, d8 = up(n, kt), up(n, qt), up(d, 8)
    dot = fma_chain(padded(xa, nqp, d8)[:, :, :, None, :],
                    padded(x, nk, d8)[:, None, None, :, :])
    kmask = padded(mask, nk)
    score = torch.where(kmask[:, None, None, :] > 0,
                        (dot + padded(cq, nqp)[..., :, None]
                         + padded(ck, nk)[..., None, :]
                         + c0[None, :, None, None]) * inv_sqrt,
                        torch.full_like(dot, NEG_INF))
    row = lambda v: padded(v, nqp)[..., :, None]
    ex = torch.exp(score - row(m))
    denom = su / se
    safe = torch.where(denom.abs() > EPS, denom, torch.ones_like(denom))
    ise = 1.0 / se
    qa = mask[:, None, :] / safe
    pd = torch.ones((b, 1, nqp, nk)) if pe is None else padded(pe, nqp,
                                                               nk)[:, None]
    dg = padded(torch.ones_like(mask) if deg is None else deg, nk)
    dg = torch.where(torch.arange(nk) < n, dg, torch.zeros_like(dg))
    attn = ex * row(ise) * (pd * dg[:, None, None, :]) * row(qa) \
        * kmask[:, None, None, :]
    valid = (torch.arange(nqp) < n)[:, None] & (torch.arange(nk) < n)[None]
    attn = torch.where(valid, attn, torch.zeros_like(attn))
    w = padded(torch.ones_like(se) if wq is None else wq, nqp)
    # each thread's partial of a tile: queries 8 n + 2 t + f of its warp's
    # group, n then f, by FMA from 0
    tiles = nqp // qt
    a = attn.reshape(b, h, tiles, groups, qw // 8, 4, 2, nk)
    wv = w.reshape(b, h, tiles, groups, qw // 8, 4, 2)[..., None]
    part = torch.zeros((b, h, tiles, groups, 4, nk))
    for nn in range(qw // 8):
        for f in range(2):
            part = (a[:, :, :, :, nn, :, f].double()
                    * wv[:, :, :, :, nn, :, f].double()
                    + part.double()).float()
    runs = run_sum([part[:, :, i] for i in range(tiles)])   # [b,h,G,4,nk]
    lanes = lane_sum([runs[:, :, :, i] for i in range(4)])   # [b,h,G,nk]
    colsum = lanes[:, :, 0]
    for grp in range(1, groups):
        colsum = colsum + lanes[:, :, grp]
    diag = torch.diagonal(attn[..., :n, :n], dim1=-2, dim2=-1)
    return colsum[..., :n], diag


def colstat_case(seed, n, pad, with_pe, with_deg, d=20):
    """B=2, H=3, D=d operands (`chip_smoke.attention_inputs`), pe zero on
    graph 0's first 3 query rows (su = 0: the guard branch), the plain
    forward's statistics and a wq in (0, 1]."""
    ops, vw = chip_smoke.attention_inputs(seed, 2, 3, n, d, 8, pad,
                                          torch.device("cpu"))
    ops["pe"][0, :3] = 0.0
    _, m, se, su = tfl.flash_fwd_plain(vw=vw, **ops)
    wq = torch.from_numpy(np.random.default_rng(seed).uniform(
        0.1, 1.0, se.shape).astype(np.float32))
    args = [ops[k] for k in ("xa", "x", "cq", "ck", "c0")] + [
        ops["pe"] if with_pe else None, ops["deg"] if with_deg else None,
        ops["mask"], ops["inv_sqrt"], m, se, su]
    n_guard = int(((su / se).abs() <= EPS).logical_and(
        ops["mask"][:, None] > 0).sum())
    return args, wq, n_guard


@pytest.mark.parametrize("n,pad", [(17, 2), (48, 5), (130, 9)])
@pytest.mark.parametrize("with_pe,with_deg", [(True, True), (False, True),
                                              (True, False)])
@pytest.mark.parametrize("weighted", [False, True])
def test_colstat_tiles_keep_f32_accuracy(n, pad, with_pe, with_deg,
                                         weighted):
    args, wq, n_guard = colstat_case(n + pad, n, pad, with_pe, with_deg)
    assert n_guard > 0 or not with_pe
    w = wq if weighted else None
    got = colstat_emulated(*args, wq=w)
    plain = tcs.colstat_plain(*args, wq=w)
    want = tcs.colstat_plain(*f64(args), wq=None if w is None else
                             w.double())
    for name, gt, p, wt in zip(("colsum", "diag"), got, plain, want):
        assert gt.shape == p.shape, name
        assert torch.isfinite(gt).all(), name
        assert torch.allclose(gt, p, **KERNEL_TOL), name
        assert torch.allclose(gt.double(), wt, **KERNEL_TOL), name
    assert mean_err(got[0], want[0]) <= CPU32_FACTOR * mean_err(
        plain[0], want[0]), (mean_err(got[0], want[0]),
                             mean_err(plain[0], want[0]))
    if n >= 130:     # enough column sums for a stable ratio of maxima
        assert max_err(got[0], want[0]) <= CPU32_FACTOR * max_err(
            plain[0], want[0]), (max_err(got[0], want[0]),
                                 max_err(plain[0], want[0]))


@pytest.mark.parametrize("n,pad", [(48, 5), (130, 9)])
@pytest.mark.parametrize("weighted", [False, True])
def test_colstat_wide_rows_keep_f32_accuracy(n, pad, weighted):
    """colstat at its wide rows (kWideW = 128 in the source, the OGB
    models' d_model): the score's FMA chain over all 128 columns, the
    column sums as at D = 64; against plain and float64 within the
    kernels' tolerance, the column sums' mean error (and at N = 130 their
    max) within 2x the CPU float32 route's."""
    d = constant("colstat.cu", "kWideW")
    assert d == 128
    args, wq, _ = colstat_case(n + pad + d, n, pad, True, True, d=d)
    assert args[0].shape[-1] == d
    w = wq if weighted else None
    got = colstat_emulated(*args, wq=w)
    plain = tcs.colstat_plain(*args, wq=w)
    want = tcs.colstat_plain(*f64(args), wq=None if w is None else
                             w.double())
    for name, gt, p, wt in zip(("colsum", "diag"), got, plain, want):
        assert torch.isfinite(gt).all(), name
        assert torch.allclose(gt, p, **KERNEL_TOL), name
        assert torch.allclose(gt.double(), wt, **KERNEL_TOL), name
    assert mean_err(got[0], want[0]) <= CPU32_FACTOR * mean_err(
        plain[0], want[0])
    if n >= 130:
        assert max_err(got[0], want[0]) <= CPU32_FACTOR * max_err(
            plain[0], want[0])


def test_colstat_geometry_covers_the_block():
    """The sources' warp tiles cover the 64-key block and the query tile
    (the emulation's reshape assumes it), with the diagonal held by one
    thread: each (key, query) pair of a tile by exactly one lane."""
    kt, groups, qw, qt = colstat_geometry()
    ek = constant("colstat.cu", "kEK")
    assert kt == 64 and qw * groups == qt and (kt // (8 * ek)) * groups == 8
    seen = torch.zeros((kt, qt), dtype=torch.int64)
    for warp in range(8):
        kr0 = 8 * ek * (warp % (kt // (8 * ek)))
        wq0 = qw * (warp // (kt // (8 * ek)))
        for lane in range(32):
            g, t = lane // 4, lane % 4
            for e in range(ek):
                for nn in range(qw // 8):
                    for f in range(2):
                        seen[kr0 + g + 8 * e, wq0 + 8 * nn + 2 * t + f] += 1
    assert bool((seen == 1).all())


# ------------------------------------------------------ fused MLP backward

def mlp_geometry(d):
    """(m-tiles a warp, units a slab, rows per tile) of bwd_kernel<D>."""
    text = (CSRC / "fused_mlp.cu").read_text()
    mt = re.search(r"MT = D == 8 \? (\d+) : (\d+);", text)
    rt = re.search(r"RT = D <= 16 \? (\d+) : (\d+);", text)
    m_tiles = int(mt.group(1) if d == 8 else mt.group(2))
    rows = int(rt.group(1) if d <= 16 else rt.group(2))
    return m_tiles, 8 * 16 * m_tiles, rows


def mlp_bwd_emulated(x, w1, b1, w2, g, rate, seed, n_sm=132):
    """bwd_kernel<D> and finish_kernel in torch: (dx, dw1, db1, dw2, db2),
    on a card with `n_sm` SMs (the split count depends on it)."""
    r, din = x.shape
    f, dout = w2.shape
    d = next(b for b in (8, 16, 32, 64) if max(din, dout) <= b)
    mt, u, rt = mlp_geometry(d)
    run_rows = constant("fused_mlp.cu", "kRunRows")
    bias_run = constant("fused_mlp.cu", "kRunTerms")
    d8i, d8o = up(din, 8), up(dout, 8)
    slabs = -(-f // u)
    want = -(-2 * n_sm // slabs)
    rps = up(-(-r // want), run_rows)
    splits = -(-r // rps)
    scale = torch.ones((r, f))
    if rate > 0:
        scale = tfm.dropout_keep(seed, r, f, rate).float() * tfm._inv_keep(
            rate)
    fp = slabs * u
    w1p, w2p, b1p = padded(w1, d8i, fp), padded(w2, fp, d8o), padded(b1, fp)
    scale_p = padded(scale, up(r, rps), fp)
    parts, dxp = [], torch.zeros((slabs, r, din))
    for sp in range(splits):
        rbeg, rend = sp * rps, min(r, (sp + 1) * rps)
        nrows = up(max(rend - rbeg, 0), rt)
        xs = torch.zeros((nrows, d8i))
        gs = torch.zeros((nrows, d8o))
        xs[:rend - rbeg, :din] = x[rbeg:rend]
        gs[:rend - rbeg, :dout] = g[rbeg:rend]
        e = torch.zeros(din * f + f + f * dout + dout)
        for sl in range(slabs):
            us = slice(sl * u, (sl + 1) * u)
            w1s, w2s, b1s = w1p[:, us], w2p[us], b1p[us]
            pre = mma_steps(b1s[:, None].expand(u, nrows).contiguous(),
                            w1s.T.contiguous(), xs.T.contiguous())
            dhd = mma_steps(torch.zeros((u, nrows)), w2s, gs.T.contiguous())
            sc = scale_p[rbeg:rbeg + nrows, us].T
            hd = torch.relu(pre) * sc
            dh = torch.where(pre > 0, dhd * sc, torch.zeros_like(dhd))
            # dW1^T, dW2: a fresh fragment per 8-row k-step into a run of
            # run_rows rows, each run into the total
            tot1, run1 = torch.zeros((u, d8i)), torch.zeros((u, d8i))
            tot2, run2 = torch.zeros((u, d8o)), torch.zeros((u, d8o))
            # db1: thread t's rows 8 k + 2 t (+1) of a tile in order into a
            # fresh partial, the tiles in runs, then the lanes
            tb, rb = torch.zeros((4, u)), torch.zeros((4, u))
            for k in range(nrows // 8):
                ks = slice(8 * k, 8 * k + 8)
                run1 = mma_steps(run1, dh[:, ks].contiguous(), xs[ks])
                run2 = mma_steps(run2, hd[:, ks].contiguous(), gs[ks])
                if k % (rt // 8) == 0:
                    pb = torch.zeros((4, u))
                for t in range(4):
                    for fr in range(2):
                        pb[t] = pb[t] + dh[:, 8 * k + 2 * t + fr]
                if (8 * (k + 1)) % run_rows == 0:
                    tot1, run1 = tot1 + run1, torch.zeros_like(run1)
                    tot2, run2 = tot2 + run2, torch.zeros_like(run2)
                if (k + 1) % (rt // 8) == 0:
                    rb = rb + pb
                    if ((k + 1) // (rt // 8)) % bias_run == 0:
                        tb, rb = tb + rb, torch.zeros_like(rb)
            tot1, tot2, tb = tot1 + run1, tot2 + run2, tb + rb
            db1 = lane_sum([tb[t] for t in range(4)])
            # dx: each warp's 16 MT units in k-steps, then the warps
            dx_s = None
            for w in range(8):
                wu = slice(16 * mt * w, 16 * mt * (w + 1))
                a = dh[wu].T.reshape(nrows // 16, 16, 16 * mt)
                share = mma_steps(torch.zeros((nrows // 16, 16, d8i)), a,
                                  w1s[:, wu].T.contiguous())
                dx_s = share if dx_s is None else dx_s + share
            dxp[sl, rbeg:rend] = dx_s.reshape(nrows, d8i)[:rend - rbeg, :din]
            lo, hi = sl * u, min(f, (sl + 1) * u)
            e[:din * f].view(din, f)[:, lo:hi] = tot1[:hi - lo, :din].T
            e[din * f + lo:din * f + hi] = db1[:hi - lo]
            e[din * f + f:din * f + f + f * dout].view(f, dout)[lo:hi] = \
                tot2[:hi - lo, :dout]
            if sl == 0:   # db2: a tile's column sum of g, runs, the total
                tot, run = torch.zeros(d8o), torch.zeros(d8o)
                for i in range(nrows // rt):
                    p = torch.zeros(d8o)
                    for rr in range(rt * i, rt * (i + 1)):
                        p = p + gs[rr]
                    run = run + p
                    if (i + 1) % bias_run == 0:
                        tot, run = tot + run, torch.zeros_like(run)
                e[-dout:] = (tot + run)[:dout]
        parts.append(e)
    grads = run_sum(parts)          # finish_kernel: runs of 8 (RunSum)
    dx = run_sum(list(dxp))
    dw1, db1, dw2, db2 = grads.split([din * f, f, f * dout, dout])
    return dx, dw1.view(din, f), db1, dw2.view(f, dout), db2


@pytest.mark.parametrize("d", [8, 20])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mlp_bwd_one_pass_keeps_f32_accuracy(d, rate):
    args = chip_smoke.mlp_inputs(d, 300, d, 520, d, "cpu", g_scale=0.05)
    x, w1, b1, w2, _, g = args
    got = mlp_bwd_emulated(x, w1, b1, w2, g, rate, 11)
    plain = tfm.fused_mlp_bwd_plain(x, w1, b1, w2, g, rate, 11)
    want = tfm.fused_mlp_bwd_plain(*f64([x, w1, b1, w2, g]), rate, 11)
    for name, gt, p, wt in zip(("dx", "dw1", "db1", "dw2", "db2"), got,
                               plain, want):
        assert gt.shape == p.shape, name
        assert torch.allclose(gt, p, **KERNEL_TOL), name
        assert torch.allclose(gt.double(), wt, **KERNEL_TOL), name
        assert max_err(gt, wt) <= CPU32_FACTOR * max_err(p, wt), (
            name, max_err(gt, wt), max_err(p, wt))


def test_mlp_bwd_splits_and_slabs_cover_every_row_and_unit():
    """The split rule of `feta_fused_mlp_bwd_grid` (whole runs of rows,
    about two blocks an SM) covers R with no empty split at the SAN shape
    and at a ragged R, and the slabs cover F."""
    run_rows = constant("fused_mlp.cu", "kRunRows")
    # finish_kernel's run length is graphit::RunSum's, which `run_sum`
    # emulates
    assert constant("fused_mlp.cu", "kRunTerms") == RUN_TILES
    for r, f, d in ((40960, 2048, 8), (10007, 2048, 8), (300, 520, 20),
                    (1, 70, 64)):
        _, u, _ = mlp_geometry(next(b for b in (8, 16, 32, 64) if d <= b))
        slabs = -(-f // u)
        rps = up(-(-r // -(-2 * 132 // slabs)), run_rows)
        splits = -(-r // rps)
        assert slabs * u >= f > (slabs - 1) * u
        assert splits * rps >= r > (splits - 1) * rps
        assert slabs * splits <= 2 * 132 + slabs
