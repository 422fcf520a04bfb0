"""The arithmetic of the tensor-core backward passes, and the backward probe.

The backward passes (`csrc/flash_bwd.cu`, `csrc/flash_hf.cu`, the query
passes' shared body `csrc/bwd_q.cuh`) take their products other than the
score on the H100's tensor cores in error-compensated TF32
(`csrc/mma_tf32.cuh`): each f32 operand is split into
hi = cvt.rna.tf32.f32(a) and lo = cvt.rna.tf32.f32(a - hi), each product
is lo·hi + hi·lo + hi·hi into a fresh f32 fragment, one 8-deep k-step at
a time, added to an f32 accumulator, and each query tile's products go
into a fresh partial. No card is
needed to check that this keeps float32 accuracy: the split and the
accumulation are emulated here in torch on the int32 view, at the paths'
shapes, and held to float64:

- the split: round to nearest, ties away from zero, at the 13 mantissa
  bits that TF32 drops;
- a score tile (16 keys x D = 64 x 16 queries) and a 2048-row update sum in
  8- to 64-row fresh partials: within the kernels' tolerance (rtol 1e-4,
  atol 1e-5) of float64, and within 4x of the plain f32 product's error;
- witnesses: one TF32 product, or the split with any one of its three
  terms dropped, misses that tolerance;
- the query passes' whole tile arithmetic (`q_pass_emulated`): the score
  as the forwards' FMA chain, ga and ds·x in 3xTF32 with a fresh fragment
  per k-step and a fresh partial per 32-key tile, dcq in per-tile partials
  summed in runs (`graphit::RunSum`), then over a row's 4 lanes and the
  strip's two warps: within the kernels' tolerance of float64 and of
  `flash_bwd_q_plain`;
- the bounded partial sums of dcq and dck over 2048 rows: no further from
  float64 than the one f32 chain per thread that the earlier kernels took,
  and near the CPU float32 route's own sum.

Also: `chip_smoke.backward_probe` (`--precision`'s backward) at a small
size on the CPU, float32 against float64, and the blocked node products of
the Chebyshev filter (`ops/cheb.py::node_matmul`) against float64.
"""

import contextlib

import numpy as np
import pytest
import torch

import chip_smoke
from feta_tmlr_tpu_torch.data.synthetic import sbm_like_dataset
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformerGenGCNSBM
from feta_tmlr_tpu_torch.ops import cheb
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as tfl
from feta_tmlr_tpu_torch.ops.kernels.common import NEG_INF
from feta_tmlr_tpu_torch.train.trainer import TrainConfig

KERNEL_TOL = chip_smoke.KERNEL_TOL          # rtol 1e-4, atol 1e-5
TERMS = ("lo_hi", "hi_lo", "hi_hi")


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: f32 x rounded to 10 explicit mantissa bits, to
    nearest with ties away from zero (on the magnitude bits of the int32
    view: add half of the 13 dropped bits, then clear them)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = ((bits + 0x1000) & 0xFFFFE000).to(torch.int32)
    return r.view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mma_product(a: torch.Tensor, b: torch.Tensor, terms=TERMS,
                k_step: int = 8) -> torch.Tensor:
    """a [M, K] @ b [K, N] as the kernels take it: per 8-deep k-step the
    terms of the split in order into a fresh f32 fragment, each term an
    exact sum of TF32 products (float64 here; the card's tensor cores
    align and truncate inside a k-step, which `--precision` measures),
    then the fragment added to the f32 accumulator."""
    ah, al = split(a)
    bh, bl = split(b)
    ops = {"lo_hi": (al, bh), "hi_lo": (ah, bl), "hi_hi": (ah, bh)}
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1], k_step):
        part = torch.zeros_like(acc)
        for term in terms:
            x, y = ops[term]
            step = x[:, k0:k0 + k_step].double() @ y[k0:k0 + k_step].double()
            part = (part.double() + step).float()
        acc = acc + part
    return acc


def tiled_product(a, b, rows, terms=TERMS):
    """a^T [M, K] @ b [K, N] over K = the query rows, each tile of `rows`
    rows into a fresh partial that is then added to the running sum (the
    kernels' update products dvw = attn^T g, dx = ds^T xa)."""
    acc = torch.zeros(a.shape[1], b.shape[1], dtype=torch.float32)
    for r0 in range(0, a.shape[0], rows):
        acc = acc + mma_product(a[r0:r0 + rows].T, b[r0:r0 + rows], terms)
    return acc


def err(got, want):
    return float((got.double() - want).abs().max())


def score_operands(seed):
    """A 16-key x 16-query score tile's operands as `bwd_inputs` makes
    them: x and xa 0.3 N(0, 1), D = 64."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(0.3 * rng.standard_normal((16, 64))).float()
    xa = torch.from_numpy(0.3 * rng.standard_normal((16, 64))).float()
    return x, xa.T.contiguous()


def update_operands(seed, n=2048, w=64):
    """attn [n, 16] (nonnegative, rows summing to about one, as the
    renormalised attention of 16 keys) and g [n, w] N(0, 1)."""
    rng = np.random.default_rng(seed)
    attn = rng.random((n, 16)) / 8.0
    g = rng.standard_normal((n, w))
    return torch.from_numpy(attn).float(), torch.from_numpy(g).float()


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),       # a tie: away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -12, 1.0),
    (1.0 + 3 * 2.0 ** -12, 1.0 + 2.0 ** -10),
    (3.0, 3.0)])
def test_tf32_rna_rounds_to_nearest_ties_away(x, want):
    got = tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert float(got) == want


def test_tf32_rna_matches_an_independent_rounding():
    """The kernels' split adds half a TF32 ulp and lets the tensor cores
    drop the 13 low bits; that is round to nearest, ties away, of the
    significand to 11 bits, computed here from frexp in float64."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(20000) * 10.0 ** rng.integers(-8, 8, 20000)
         ).astype(np.float32)
    x[:4] = [1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 3.0, -0.0]
    m, e = np.frexp(x.astype(np.float64))          # |m| in [0.5, 1)
    want = np.sign(m) * np.floor(np.abs(m) * 2.0 ** 11 + 0.5) * 2.0 ** (
        e - 11)
    got = tf32_rna(torch.from_numpy(x)).double().numpy()
    np.testing.assert_array_equal(got, want)


def test_split_is_exact_to_f32_and_hi_is_tf32():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(10000) * 10.0 ** rng.integers(
        -6, 6, 10000)).float()
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    # hi + lo carries 22 of f32's 24 significant bits
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert rel <= 2.0 ** -21


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_score_tile_keeps_f32_accuracy(seed):
    """A 16 x 64 by 64 x 16 score tile (keys x D by D x queries)."""
    x, xa_t = score_operands(seed)
    want = x.double() @ xa_t.double()
    got = mma_product(x, xa_t)
    plain = x @ xa_t
    assert torch.allclose(got.double(), want, **KERNEL_TOL)
    assert err(got, want) <= 4 * max(err(plain, want), 1e-9)


@pytest.mark.parametrize("rows", [8, 16, 32, 64])
def test_split_update_sum_over_2048_rows_keeps_f32_accuracy(rows):
    """dvw = attn^T g over 2048 query rows in fresh partials of `rows`
    rows (8: the folded kernel's query tile; 32: the unfolded one's)."""
    attn, g = update_operands(rows)
    want = attn.double().T @ g.double()
    got = tiled_product(attn, g, rows)
    plain = attn.T @ g
    assert torch.allclose(got.double(), want, **KERNEL_TOL)
    assert err(got, want) <= 4 * err(plain, want)


@pytest.mark.parametrize("terms", [("hi_hi",), ("hi_lo", "hi_hi"),
                                   ("lo_hi", "hi_hi"), ("lo_hi", "hi_lo")])
def test_split_without_a_term_misses_the_kernel_tolerance(terms):
    """Witnesses: one TF32 product, or the split with a term dropped, is
    not within rtol 1e-4 / atol 1e-5 of float64 on the score tile or on
    the update sum. If the kernels' split lost a term, their checks would
    fail as these do."""
    x, xa_t = score_operands(0)
    attn, g = update_operands(3)
    tile_ok = torch.allclose(mma_product(x, xa_t, terms).double(),
                             x.double() @ xa_t.double(), **KERNEL_TOL)
    sum_ok = torch.allclose(tiled_product(attn, g, 32, terms).double(),
                            attn.double().T @ g.double(), **KERNEL_TOL)
    assert not (tile_ok and sum_ok)


# ------------------------------------------------------ the query passes

STRIP, KEYS, RUN_TILES = 16, 32, 8      # bwd_q.cuh, graphit::RunSum


def fma_chain(a, b):
    """sum_k a[..., k] b[..., k] as the forwards' FMA chain: from 0, k in
    order, each step a·b + s rounded once to f32 (here the exact float64
    product and sum, then f32): the score that the kernels' dot4 repeats."""
    s = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1])
    for k in range(a.shape[-1]):
        s = (s.double() + a[..., k].double() * b[..., k].double()).float()
    return s


def run_sum(parts):
    """graphit::RunSum over a thread's per-tile partials (a list of f32
    tensors): each joins a run of RUN_TILES tiles, each complete run the
    total; the total and the open run added last."""
    total = run = torch.zeros_like(parts[0])
    for i, p in enumerate(parts):
        run = run + p
        if i % RUN_TILES == RUN_TILES - 1:
            total, run = total + run, torch.zeros_like(run)
    return total + run


def lane_sum(v):
    """The 4 lanes t of a row after __shfl_xor 1 then 2, as lane 0 holds
    it: (v0 + v1) + (v2 + v3)."""
    return (v[0] + v[1]) + (v[2] + v[3])


def warp_keys(u, t):
    """The keys of a 32-key tile whose ds thread t of warp half u holds,
    in the order it adds them (n-tile 0 then 1, columns 2t then 2t + 1)."""
    return [16 * u + 2 * t, 16 * u + 2 * t + 1, 16 * u + 8 + 2 * t,
            16 * u + 9 + 2 * t]


def q_pass_emulated(xa, x, cq, ck, c0, vw, pe, deg, mask, inv_sqrt, g, m,
                    ise, qa, beta, c):
    """flash_bwd_q's and flash_bwd_q_hf's arithmetic (bwd_q.cuh: both grids
    compute each 16-query strip alike) in torch: (dxa, dcq)."""
    b_, h_, n, d = xa.shape
    dv = vw.shape[-1]
    np_ = -(-n // KEYS) * KEYS
    pad = lambda t, dims: torch.nn.functional.pad(t, dims)
    w8 = lambda w: -(-w // 8) * 8
    # the staged tiles: rows past N and columns past the width are zero
    xa_p = pad(xa, (0, w8(d) - d, 0, np_ - n))
    x_p = pad(x, (0, w8(d) - d, 0, np_ - n))
    g_p = pad(g, (0, w8(dv) - dv, 0, np_ - n))
    vw_p = pad(vw, (0, w8(dv) - dv, 0, np_ - n))
    dot = fma_chain(xa_p[:, :, :, None, :], x_p[:, None, None, :, :])
    km = pad(mask, (0, np_ - n))
    row = lambda t: pad(t, (0, np_ - n))[..., :, None]
    s = torch.where(km[:, None, None, :] > 0,
                    (dot + row(cq) + pad(ck, (0, np_ - n))[..., None, :]
                     + c0[None, :, None, None]) * inv_sqrt,
                    torch.full_like(dot, NEG_INF))
    pd = torch.ones((b_, 1, np_, np_))
    if pe is not None:
        pd = pd * pad(pe, (0, np_ - n, 0, np_ - n))[:, None]
    if deg is not None:
        pd = pd * pad(deg, (0, np_ - n))[:, None, None, :]
    valid = torch.zeros(np_, dtype=torch.bool)
    valid[:n] = True
    valid = valid[:, None] & valid[None, :]
    dxa = torch.zeros((b_, h_, np_, w8(d)))
    dcq = torch.zeros((b_, h_, np_))
    for bi in range(b_):
        for hi in range(h_):
            for q0 in range(0, np_, STRIP):
                qs = slice(q0, q0 + STRIP)
                acc = torch.zeros((STRIP, w8(d)))
                parts = {(u, t): [] for u in range(2) for t in range(4)}
                for k0 in range(0, np_, KEYS):
                    ks = slice(k0, k0 + KEYS)
                    ga = mma_product(g_p[bi, hi, qs].contiguous(),
                                     vw_p[bi, hi, ks].T.contiguous())
                    a = torch.exp(s[bi, hi, qs, ks]
                                  - row(m)[bi, hi, qs]) * row(ise)[bi, hi, qs]
                    kmt = km[bi, None, ks]
                    du = ga * kmt * row(qa)[bi, hi, qs] - row(beta)[bi, hi, qs]
                    ds = a * (du * pd[bi, 0, qs, ks]
                              - row(c)[bi, hi, qs]) * inv_sqrt
                    ds = torch.where(valid[qs, ks], ds, torch.zeros_like(ds))
                    for (u, t), lst in parts.items():
                        p = torch.zeros(STRIP)
                        for j in warp_keys(u, t):
                            p = p + ds[:, j]
                        lst.append(p)
                    acc = acc + mma_product(ds, x_p[bi, ks].contiguous())
                halves = [lane_sum([run_sum(parts[u, t]) for t in range(4)])
                          for u in range(2)]
                dxa[bi, hi, qs] = acc
                dcq[bi, hi, qs] = halves[0] + halves[1]
    return dxa[:, :, :n, :d], dcq[:, :, :n]


@pytest.mark.parametrize("b,h,n,pad,d,dv", [
    (2, 2, 70, 5, 20, 12), (1, 2, 64, 0, 64, 64), (2, 3, 33, 1, 16, 8)])
def test_q_pass_tiles_keep_f32_accuracy(b, h, n, pad, d, dv):
    """The query passes' tile arithmetic, emulated, on `bwd_inputs`'
    operands (guard rows included), against float64 and the plain f32
    version, within the kernels' tolerance; dxa within 4x of the plain
    version's own error."""
    args, _, _ = chip_smoke.bwd_inputs(b + n + dv, b, h, n, d, dv, pad,
                                       torch.device("cpu"),
                                       guard_rows=min(n, 4))
    got = q_pass_emulated(*args)
    want = tfl.flash_bwd_q_plain(*[t.double() if torch.is_tensor(t) else t
                                   for t in args])
    plain = tfl.flash_bwd_q_plain(*args)
    for gt, w, p in zip(got, want, plain):
        assert torch.allclose(gt.double(), w, **KERNEL_TOL)
        assert torch.allclose(gt, p, **KERNEL_TOL)
    assert err(got[0], want[0]) <= 4 * err(plain[0], want[0])


def thread_sums(v, tile, keys, halves, runs):
    """A row's sum over the v's last axis as a backward pass takes it:
    thread t of each warp half u adds its keys(u, t) of each `tile`-term
    tile, either all into one f32 chain (the earlier kernels) or into a
    fresh partial per tile summed in runs (`run_sum`); then the 4 lanes
    (`lane_sum`) and the halves in order."""
    out = None
    for u in range(halves):
        lanes = []
        for t in range(4):
            chain, parts = torch.zeros(v.shape[0]), []
            for k0 in range(0, v.shape[1], tile):
                p = torch.zeros(v.shape[0])
                for j in keys(u, t):
                    if runs:
                        p = p + v[:, k0 + j]
                    else:
                        chain = chain + v[:, k0 + j]
                parts.append(p)
            lanes.append(run_sum(parts) if runs else chain)
        total = lane_sum(lanes)
        out = total if out is None else out + total
    return out


@pytest.mark.parametrize("pass_", ["q", "k", "k_hf"])
def test_bounded_partials_over_2048_rows_match_the_cpu_sum(pass_):
    """dcq (query passes: 32-key tiles) and dck (key passes: 32-query
    tiles; the folded key pass: 8-query tiles, 2 of its terms a thread
    each, its query loop split in two and the splits added in order) over
    2048 ds-like terms (mixed signs, heavy-tailed), 256 rows: the bounded
    partials no further from float64 than one chain per thread, in max and
    mean, and their mean error within 1.5x of torch's own float32 sum on
    the CPU (the route `--precision` holds the card to)."""
    rng = np.random.default_rng(len(pass_))
    w = rng.exponential(1.0, (256, 2048)) ** 2
    v = torch.from_numpy(rng.standard_normal((256, 2048)) * w * 0.015
                         ).float()
    want = v.double().sum(1)
    if pass_ == "k_hf":
        fold = lambda u, t: [2 * t, 2 * t + 1]
        sums = lambda runs: sum(
            (thread_sums(v[:, i:i + 1024], 8, fold, 1, runs)
             for i in (0, 1024)), torch.zeros(256))
    else:
        sums = lambda runs: thread_sums(v, 32, warp_keys, 2, runs)
    errs = {k: (got.double() - want).abs() for k, got in
            (("runs", sums(True)), ("chain", sums(False)),
             ("cpu", v.sum(1)))}
    assert errs["runs"].max() <= errs["chain"].max()
    assert errs["runs"].mean() <= errs["chain"].mean()
    assert errs["runs"].mean() <= 1.5 * errs["cpu"].mean()


def _probe_graphs(n_graphs, n_nodes):
    graphs = sbm_like_dataset(seed=2, n_graphs=n_graphs, n_nodes=n_nodes)
    for g in graphs:
        g.pe, g.lap_pe = chip_smoke._pe_worker(g)
    return graphs


@pytest.mark.parametrize("setting", ["fold", "stream"])
def test_backward_probe_float32_against_float64(setting):
    """`--precision`'s backward probe at two layers of width 16, N=64, on
    the CPU: every part's backward re-run in float32 lies within 1e-4 of
    the float64 re-run's largest entry (the probe itself checks that the
    float64 re-run reproduces the float64 step's parameter gradients),
    and every part and gradient is reported."""
    cfg = dict(chip_smoke.MODEL_CFG, d_model=16, nb_heads=2, nb_layers=2)
    model = DiffGraphTransformerGenGCNSBM(
        **cfg, **chip_smoke.LARGE_SETTINGS[setting], seed=1, device="cpu")
    graphs = chip_smoke.sign_pattern(_probe_graphs(2, 64), 4)[:1]
    routes = {"cpu64": ("cpu", torch.float64, contextlib.nullcontext),
              "cpu32": ("cpu", torch.float32, contextlib.nullcontext)}
    errs = chip_smoke.backward_probe(
        model, graphs, dict(max_nodes=64, node_labels=True),
        TrainConfig(regularization=0.1, sign_flip=False), routes, "N=64")
    assert list(errs) == ["encoder.layers.0", "encoder.layers.1",
                          "encoder.coeff_head", "encoder.cheb_filter",
                          "encoder.linear_cat", "classifier"]
    for i in range(2):
        layer = errs[f"encoder.layers.{i}"]
        assert {"in0", *chip_smoke.PROBE_PARAMS["layer"],
                *chip_smoke.FLASH_GRADS} <= set(layer)
    assert set(errs["encoder.cheb_filter"]) == {"in0", "in2", "in3"}
    worst = max(e["cpu32"] for part in errs.values() for e in part.values())
    assert 0.0 < worst < 1e-4


@pytest.mark.parametrize("m,k,n", [(48, 64, 8), (200, 200, 8),
                                   (2048, 2048, 8)])
def test_node_matmul_matches_float64(m, k, n):
    """The node product: forward and both gradients equal the plain
    product in float64, and in float32 each lies within the kernels'
    tolerance of float64, the broadcast Lhat [B, 1, N, N] included (the
    first case, within one block, takes the plain product)."""
    rng = np.random.default_rng(m + k)
    a64 = torch.from_numpy(rng.standard_normal((2, 1, m, k)) / np.sqrt(k))
    b64 = torch.from_numpy(rng.standard_normal((2, 3, k, n)))
    g64 = torch.from_numpy(rng.standard_normal((2, 3, m, n)))

    def run(fn, a, b, g):
        a = a.clone().requires_grad_()
        b = b.clone().requires_grad_()
        out = fn(a, b)
        da, db = torch.autograd.grad(out, (a, b), g)
        return out.detach(), da, db

    want = run(torch.matmul, a64, b64, g64)
    got64 = run(cheb.node_matmul, a64, b64, g64)
    got32 = run(cheb.node_matmul, a64.float(), b64.float(), g64.float())
    for w, g64_, g32 in zip(want, got64, got32):
        assert g64_.shape == w.shape
        scale = float(w.abs().max())
        assert float((g64_ - w).abs().max()) <= 1e-12 * scale
        assert float((g32.double() - w).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("k", [48, 200])
def test_head_sum_matmul_matches_float64(k):
    """sum_h a_h @ b_h (the score route's attn @ vw, need_heads off): the
    forward and both gradients equal the einsum in float64, and in float32
    lie within the kernels' tolerance of float64 (K = 48: the einsum
    itself; K = 200: per-head blocked products, then the head sum)."""
    rng = np.random.default_rng(k)
    a64 = torch.from_numpy(rng.random((2, 3, 40, k)) / k)
    b64 = torch.from_numpy(rng.standard_normal((2, 3, k, 16)))
    g64 = torch.from_numpy(rng.standard_normal((2, 40, 16)))

    def run(fn, a, b, g):
        a = a.clone().requires_grad_()
        b = b.clone().requires_grad_()
        out = fn(a, b)
        return (out.detach(), *torch.autograd.grad(out, (a, b), g))

    want = run(lambda a, b: torch.einsum("bhnm,bhmf->bnf", a, b),
               a64, b64, g64)
    got64 = run(cheb.head_sum_matmul, a64, b64, g64)
    got32 = run(cheb.head_sum_matmul, a64.float(), b64.float(), g64.float())
    for w, g64_, g32 in zip(want, got64, got32):
        scale = float(w.abs().max())
        assert float((g64_ - w).abs().max()) <= 1e-12 * scale
        assert float((g32.double() - w).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("k_order", [2, 4])
def test_cheb_filter_blocked_matches_einsum_float64(k_order):
    """`cheb_filter_dynamic` through the blocked products against its
    einsum formula in float64, values and gradients, at N=150 (a ragged
    last block)."""
    rng = np.random.default_rng(k_order)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s))
    x, lhat = t(2, 3, 150, 4), t(2, 150, 150) / 12.0
    w, bias = t(2, 3, k_order, 4, 5), t(5)

    def einsum_filter(x, lhat, w, bias):
        lh = lhat[:, None]
        tx_prev, out = x, torch.einsum("bhnd,bhde->bhne", x, w[:, :, 0])
        tx_cur = lh @ x
        out = out + torch.einsum("bhnd,bhde->bhne", tx_cur, w[:, :, 1])
        for k in range(2, k_order):
            tx_next = 2.0 * (lh @ tx_cur) - tx_prev
            out = out + torch.einsum("bhnd,bhde->bhne", tx_next, w[:, :, k])
            tx_prev, tx_cur = tx_cur, tx_next
        return out + bias

    results = []
    for fn in (einsum_filter, cheb.cheb_filter_dynamic):
        xs, ws, bs = (v.clone().requires_grad_() for v in (x, w, bias))
        out = fn(xs, lhat, ws, bs)
        grads = torch.autograd.grad(out, (xs, ws, bs), torch.ones_like(out))
        results.append((out.detach(), *grads))
    for a, b in zip(*results):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
