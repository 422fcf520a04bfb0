"""The fused attention kernels' arithmetic, emulated on the CPU.

`csrc/fused_attention.cu` launches one thread-block cluster per graph of
`cluster_size(H)` CTAs, each CTA H / C consecutive heads and each warp one
16-query strip. No card is needed to check that its arithmetic keeps
float32 accuracy: it is emulated here in torch, step by step in the
kernels' order, with `test_torch_tf32_split.py`'s TF32 split:

- the score as the FMA chain of `graphit_tile.cuh::dot4`, k in order;
- the exact row softmax, each row sum a thread's keys 8 n + 2 t, 8 n + 2 t
  + 1 in order, then the row's 4 lanes; one division a row for the
  forward's normaliser and the backward's 1 / safe, a = e / se per score;
- every other product (P·V; ga = g vw^T, dxa = ds x, dvw = attn^T g,
  dx = ds^T xa) in 3xTF32, a fresh fragment per 8-deep k-step added to an
  f32 accumulator, which runs on over a CTA's heads for out and dx;
- dck as each strip's column sums (its rows g and g + 8, then the 8 row
  lanes, xor 4, 8, 16) added in strip order, dc0 as one warp's sum of dck;
- the cluster's head sum: CTA r sums rows r, r + C, ... of the CTAs'
  partials in rank order 0 .. C-1.

(a) At B=3, N=48 (H=8: one head a CTA) and at N=128 (H=12: two heads a
CTA), with padded nodes and guard rows, each output is within rtol 1e-4 /
atol 1e-5 of the plain version and, against float64, within 2x the CPU
float32 route's own error (the plain version in float32 on the CPU).
(b) The head-group rule, and the rank-order head sum equal bit for bit to a
sequential sum in that order.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from feta_tmlr_tpu_torch.ops.kernels import fused_attention as tfa
from feta_tmlr_tpu_torch.ops.kernels.common import EPS, NEG_INF
from test_torch_tf32_split import fma_chain, split

KERNEL_TOL = chip_smoke.KERNEL_TOL          # rtol 1e-4, atol 1e-5
CPU32_FACTOR = 2                            # error over the CPU f32 route's
OUTS_BWD = ("dxa", "dx", "dcq", "dck", "dc0", "dvw")


def up(n, m):
    return -(-n // m) * m


def padded(t, *sizes):
    """t zero-padded at the end of its last len(sizes) dims to `sizes`."""
    pads = []
    for dim, size in zip(range(t.dim() - 1, -1, -1), reversed(sizes)):
        pads += [0, size - t.shape[dim]]
    return torch.nn.functional.pad(t, pads)


def mma_steps(acc, a, b):
    """acc + a @ b as mma_tf32.cuh's mma3 takes it, batched: per 8-deep
    k-step the split's terms lo·hi, hi·lo, hi·hi exactly into a fresh f32
    fragment (float64 here, each term rounded once), then the fragment
    added to the f32 accumulator (test_torch_tf32_split.mma_product)."""
    ah, al = split(a)
    bh, bl = split(b)
    for k0 in range(0, a.shape[-1], 8):
        k = slice(k0, k0 + 8)
        part = torch.zeros_like(acc)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            part = (part.double()
                    + x[..., k].double() @ y[..., k, :].double()).float()
        acc = acc + part
    return acc


def butterfly(v, offsets):
    """The value a warp's lane 0 holds after `v += shfl_xor(v, off)` for
    each offset, v's last dim indexing the lanes taking part."""
    idx = torch.arange(v.shape[-1])
    for off in offsets:
        v = v + v[..., idx ^ off]
    return v[..., 0]


def row_sum(v):
    """A row's sum over its keys [..., NK] as the kernels take it: thread t
    adds keys 8 n + 2 t, 8 n + 2 t + 1 for n in order, then the row's 4
    lanes (xor 1, 2)."""
    v = v.reshape(*v.shape[:-1], v.shape[-1] // 8, 4, 2)
    acc = torch.zeros(v.shape[:-3] + (4,))
    for n in range(v.shape[-3]):
        for f in range(2):
            acc = acc + v[..., n, :, f]
    return butterfly(acc, (1, 2))


def cluster_sum(parts):
    """The head sum over the cluster's partials [B, NR, D8]: CTA r takes
    rows r, r + C, ... and adds the CTAs' partials in rank order 0 .. C-1,
    from 0."""
    c = len(parts)
    out = torch.empty_like(parts[0])
    for r in range(c):
        v = torch.zeros_like(parts[0][:, r::c])
        for q in range(c):
            v = v + parts[q][:, r::c]
        out[:, r::c] = v
    return out


def head_groups(h):
    """The heads of each CTA of a graph's cluster, in order."""
    c = tfa.cluster_size(h)
    return [list(range(r * (h // c), (r + 1) * (h // c))) for r in range(c)]


def chain(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt):
    """The steps both kernels share, on the staged (zero-padded) operands:
    (e = exp(s - m), pd, se, su, qmask, kmask, staged x, xa, vw)."""
    b, h, n, d = xa.shape
    nr, nk, d8 = up(n, 16), up(n, 8), up(d, 8)
    x_p, xa_p, vw_p = (padded(t, nr, d8) for t in (x, xa, vw))
    dot = fma_chain(xa_p[:, :, :, None, :], x_p[:, None, None, :nk, :])
    km, qm = padded(mask, nk), padded(mask, nr)
    s = ((dot + padded(cq, nr)[..., :, None]) + padded(ck, nk)[..., None, :]
         + c0[None, :, None, None]) * inv_sqrt
    s = torch.where(km[:, None, None, :] > 0, s, torch.full_like(s, NEG_INF))
    s[..., n:] = -torch.inf                  # keys past N
    e = torch.exp(s - s.amax(-1, keepdim=True))
    pd = torch.ones((b, 1, nr, nk))
    if pe is not None:
        pd = pd * padded(pe, nr, nk)[:, None]
    if deg is not None:
        pd = pd * padded(deg, nk)[:, None, None, :]
    return (e, pd, row_sum(e), row_sum(e * pd), qm, km, x_p, xa_p, vw_p)


def fwd_emulated(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt):
    """fused_fwd_kernel's arithmetic: out [B, N, D]."""
    n, d = xa.shape[2], xa.shape[3]
    e, pd, se, su, qm, km, _, _, vw_p = chain(xa, x, cq, ck, c0, vw, pe, deg,
                                              mask, inv_sqrt)
    nk = pd.shape[-1]
    r = qm[:, None] / torch.where((su / se).abs() > EPS, su, se)
    p = ((e * pd) * km[:, None, None, :]) * r[..., None]
    parts = []
    for heads in head_groups(xa.shape[1]):
        acc = torch.zeros((xa.shape[0], p.shape[2], vw_p.shape[-1]))
        for hd in heads:
            acc = mma_steps(acc, p[:, hd], vw_p[:, hd, :nk])
        parts.append(acc)
    return cluster_sum(parts)[:, :n, :d]


def bwd_emulated(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g):
    """fused_bwd_kernel's arithmetic: (dxa, dx, dcq, dck, dc0, dvw)."""
    b, h, n, d = xa.shape
    e, pd, se, su, qm, km, x_p, xa_p, vw_p = chain(
        xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt)
    nr, nk = pd.shape[2], pd.shape[3]
    g_p = padded(g, nr, vw_p.shape[-1])
    on = ((su / se).abs() > EPS).float()
    isafe = torch.where(on > 0, se / su, torch.ones_like(se))
    ga = mma_steps(torch.zeros((b, h, nr, nk)), g_p[:, None],
                   vw_p[..., :nk, :].transpose(-1, -2))
    qk = qm[:, None, :, None] * km[:, None, None, :]
    gm = ga * qk
    a = e / se[..., None]
    rs = row_sum((gm * a) * pd)
    beta = ((rs * isafe) * isafe) * on
    da = (gm * isafe[..., None] - beta[..., None]) * pd
    ts = row_sum(da * a)
    ds = (a * (da - ts[..., None])) * inv_sqrt
    attn = ((a * pd) * isafe[..., None]) * qk
    # dck: each strip's rows g and g + 8, its 8 row lanes, then the strips
    strips = ds.reshape(b, h, nr // 16, 2, 8, nk)
    per_strip = butterfly((strips[:, :, :, 0] + strips[:, :, :, 1])
                          .transpose(-1, -2), (1, 2, 4))
    dck = torch.zeros((b, h, nk))
    for w in range(nr // 16):
        dck = dck + per_strip[:, :, w]
    dck = dck[..., :n]
    lanes = torch.zeros((b, h, 32))
    for j0 in range(0, n, 32):
        lanes = lanes + padded(dck[..., j0:j0 + 32], 32)
    dc0 = butterfly(lanes, (16, 8, 4, 2, 1))
    zeros = lambda rows: torch.zeros((b, h, rows, vw_p.shape[-1]))
    dxa = mma_steps(zeros(nr), ds, x_p[:, None, :nk])
    dvw = mma_steps(zeros(nk), attn[..., :nk, :].transpose(-1, -2),
                    g_p[:, None, :nk])
    parts = []
    for heads in head_groups(h):
        acc = torch.zeros((b, nk, vw_p.shape[-1]))
        for hd in heads:
            acc = mma_steps(acc, ds[:, hd, :nk].transpose(-1, -2),
                            xa_p[:, hd, :nk])
        parts.append(acc)
    return (dxa[..., :n, :d], cluster_sum(parts)[:, :n, :d],
            row_sum(ds)[..., :n], dck, dc0, dvw[..., :n, :d])


def case(seed, b, h, n, pad, d):
    """chip_smoke's fused-attention operands on the CPU (`fused_inputs`:
    graph i loses its last pad + i nodes, pe is 0 on graph 0's first 4
    query rows, the |denom| <= 1e-9 branch) and the cotangent g."""
    ops, vw, g = chip_smoke.fused_inputs(seed, b, h, n, d, pad,
                                         torch.device("cpu"))
    return (ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"], vw,
            ops["pe"], ops["deg"], ops["mask"], ops["inv_sqrt"]), g


@pytest.fixture(autouse=True, scope="module")
def warm_exp():
    """One multithreaded float32 torch.exp before the checks: the first of a
    process has been seen to return values 1e-4 off on the CPU (torch 2.x),
    which would fail a check for reasons outside the kernels."""
    torch.exp(torch.zeros(1 << 18))


def f64(args):
    return [t.double() if torch.is_tensor(t) else t for t in args]


def max_err(got, want):
    return float((got.double() - want).abs().max())


# (B, H, N, padding, D): the ZINC batch's N = 48 at H = 8 (one head a
# CTA); N = 128, the kernels' largest, at H = 12 (clusters of 6, two heads a
# CTA); N = 17 past one strip at D = 20 (the K edge) and H = 3
CASES = [(3, 8, 48, 5, 64), (2, 12, 128, 9, 64), (3, 3, 17, 2, 20)]


@pytest.mark.parametrize("b,h,n,pad,d", CASES)
def test_fused_fwd_tiles_keep_f32_accuracy(b, h, n, pad, d):
    args, _ = case(b + n, b, h, n, pad, d)
    got = fwd_emulated(*args)
    plain = tfa.fused_attn_fwd_plain(*args)
    want = tfa.fused_attn_fwd_plain(*f64(args))
    assert torch.isfinite(got).all()
    assert torch.allclose(got, plain, **KERNEL_TOL)
    assert torch.allclose(got.double(), want, **KERNEL_TOL)
    assert max_err(got, want) <= CPU32_FACTOR * max_err(plain, want)


@pytest.mark.parametrize("b,h,n,pad,d", CASES)
def test_fused_bwd_tiles_keep_f32_accuracy(b, h, n, pad, d):
    args, g = case(b + n, b, h, n, pad, d)
    got = bwd_emulated(*args, g)
    plain = tfa.fused_attn_bwd_plain(*args, g)
    want = tfa.fused_attn_bwd_plain(*f64(args), g.double())
    for name, gt, p, w in zip(OUTS_BWD, got, plain, want):
        assert gt.shape == p.shape, name
        assert torch.isfinite(gt).all(), name
        assert torch.allclose(gt, p, **KERNEL_TOL), name
        assert torch.allclose(gt.double(), w, **KERNEL_TOL), name
        assert max_err(gt, w) <= CPU32_FACTOR * max_err(p, w), (
            name, max_err(gt, w), max_err(p, w))


@pytest.mark.parametrize("h,c", [(1, 1), (3, 3), (8, 8), (12, 6), (13, 1)])
def test_head_groups_are_the_largest_divisor_at_most_8(h, c):
    """C = the largest divisor of H that is at most 8, H / C consecutive
    heads a CTA, every head in one CTA; the kernels' source takes the same
    bound."""
    assert tfa.cluster_size(h) == c
    groups = head_groups(h)
    assert len(groups) == c and all(len(gr) == h // c for gr in groups)
    assert sum(groups, []) == list(range(h))
    src = (Path(tfa.__file__).resolve().parents[2] / "csrc"
           / "fused_attention.cu").read_text()
    assert re.search(r"kMaxCluster = (\d+);", src).group(1) == str(
        tfa.MAX_CLUSTER)


@pytest.mark.parametrize("c", [1, 3, 6, 8])
def test_rank_order_head_sum_is_a_sequential_sum(c):
    """The cluster's head sum, row r by CTA r mod C, is bit for bit the
    sequential sum of the partials in rank order; the reverse order differs
    (so the order is what the check sees)."""
    rng = np.random.default_rng(c)
    parts = [torch.from_numpy(rng.standard_normal((2, 48, 64))
                              * 10.0 ** rng.integers(-3, 3, (2, 48, 64))
                              ).float() for _ in range(c)]
    seq = torch.zeros_like(parts[0])
    for p in parts:
        seq = seq + p
    assert torch.equal(cluster_sum(parts), seq)
    rev = torch.zeros_like(parts[0])
    for p in reversed(parts):
        rev = rev + p
    assert torch.equal(seq, rev) == (c < 3)
