"""The modulation kernels' arithmetic, emulated on the CPU, and the exact
zeros that let them skip masked cells.

`csrc/modulation.cu` holds a query row in the registers of a team of T
threads, V groups of 4 keys a thread (`team_geometry` beside the wrapper,
tied here to the source's `geometry`), loops over the heads and never reads
a masked cell. No card is needed to check that its arithmetic keeps float32
accuracy: it is emulated here in torch, step by step in the kernel's order.

(a) The emulation: the row's keys laid out as the kernel loads them (16-byte
groups consecutive across the team where N % 4 == 0, else keys strided by
T); the maximum over the real keys; e = exp(s - m) once; each thread's
partial sums of e and of e * p in float32 (a group's four pairwise, then
the groups), the team's sums of the second in float64: xor butterflies
within a group of lanes (at most 32), then the warps' sums in warp order;
where |sp| > 1e-9 se, attn = e * p / sp and ds = attn * (gm - sum gm *
attn), else attn = e / se * p and ds = a * (gm * p - sum gm * p * a), the
backward's sum over its float32 products in float64 element by element;
each division as the kernel's (Markstein: a * y and one correction from y
= 1 / b rounded, held here to the IEEE quotient bit for bit). At N of 1, 17, 48,
128 and 2048 (small B and H; padded nodes, a graph with every node masked
at N = 1, guard rows whose pe is 0, pe and degree absent at N = 128):
within rtol 1e-4 / atol 1e-5 of the plain version, and each output's max
abs error from a float64 run of the plain version within 2x the CPU
float32 route's (`chip_smoke.py` holds the card's to the same 2x at the
ZINC batch and at B=1, N=2048).

(b) The JAX kernels (`feta_tmlr_tpu/ops/pallas/modulation.py`, in interpret
mode) and the port's plain versions give exactly 0 at every cell whose
query or key is masked, forward and backward, with a graph whose nodes are
all masked: so the kernel may write 0 there without reading the cell.

(c) `chip_smoke.modulation_cost`, the bytes the function needs on a given
mask, against a count by hand.
"""

import re
from pathlib import Path

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from feta_tmlr_tpu.ops.pallas import modulation as jmod
from feta_tmlr_tpu_torch.ops.kernels import modulation as tmod
from feta_tmlr_tpu_torch.ops.kernels.common import EPS, NEG_INF
from test_torch_fused_tiles import warm_exp  # noqa: F401

KERNEL_TOL = chip_smoke.KERNEL_TOL          # rtol 1e-4, atol 1e-5
CPU32_FACTOR = 2                            # error over the CPU f32 route's
SOURCE = (Path(tmod.__file__).resolve().parents[2] / "csrc"
          / "modulation.cu").read_text()


def test_geometry_is_the_sources():
    """The Python mirror of the launcher's `geometry` against its lines."""
    wide = int(re.search(r"constexpr int kWideMax = (\d+);", SOURCE)[1])
    body = re.search(r"void geometry\(int N, int\* T, int\* V\) \{(.*?)\n\}",
                     SOURCE, re.S)[1]
    for line in ("const int groups = (N + 3) / 4;",
                 "*V = groups <= 32 ? 1 : 4;", "int t = 1;",
                 "while (t * *V < groups) t *= 2;", "*T = t;"):
        assert line in body
    assert "if (a.T > kWideMax)" in SOURCE
    assert wide == tmod.WIDE_MAX
    geo = tmod.team_geometry
    assert [geo(n) for n in (1, 4, 17, 48, 128, 129, 300, 1024, 1990, 2048)] \
        == [(1, 1), (1, 1), (8, 1), (16, 1), (32, 1), (16, 4), (32, 4),
            (64, 4), (128, 4), (128, 4)]
    assert geo(16 * wide) == (wide, 4) and geo(16 * wide + 1) is None


def div_rn(a, b, y):
    """The kernel's a / b from y = 1 / b rounded: q = a * y, the remainder
    a - q * b (exact in float64), q + r * y rounded once."""
    q = a * y
    r = (a.double() - q.double() * b.double()).float()
    return (r.double() * y.double() + q.double()).float()


def test_division_is_rounded_to_nearest():
    """Markstein's theorem on the kernel's operand ranges: div_rn gives
    the IEEE quotient bit for bit (a = e or e * p in [0, 1], b = sp or se
    in [1e-9, 1e4])."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.random(1 << 20).astype(np.float32))
    a[::7] *= torch.from_numpy(rng.random(a[::7].shape).astype(np.float32))
    b = torch.from_numpy(10.0 ** rng.uniform(-9, 4, 1 << 20)).float()
    assert torch.equal(div_rn(a, b, 1.0 / b), a / b)


def thread_sum(x):
    """A thread's partial sums [..., T] of x [..., T, V, 4]: each group's
    four pairwise, then the groups in order."""
    g = (x[..., 0] + x[..., 1]) + (x[..., 2] + x[..., 3])
    s = g[..., 0]
    for v in range(1, g.shape[-1]):
        s = s + g[..., v]
    return s


def layout(n):
    """The key of each (thread t, group v, element q) of a row, [T, V, 4];
    -1 past N."""
    t, v = tmod.team_geometry(n)
    tt = torch.arange(t)[:, None, None]
    vv = torch.arange(v)[None, :, None]
    qq = torch.arange(4)[None, None, :]
    key = 4 * (vv * t + tt) + qq if n % 4 == 0 else (4 * vv + qq) * t + tt
    return torch.where(key < n, key, -1)


def team_sum(x):
    """Thread partials [..., T] summed as the team sums them: xor
    butterflies over a group of lanes (all of them end equal), then the
    warps' sums in warp order."""
    lanes = min(x.shape[-1], 32)
    x = x.reshape(*x.shape[:-1], -1, lanes)
    off = lanes // 2
    while off:
        x = x + x[..., torch.arange(lanes) ^ off]
        off //= 2
    total = x[..., 0, 0]
    for w in range(1, x.shape[-2]):
        total = total + x[..., w, 0]
    return total


def emulate(scores, pe, deg, mask, g=None):
    """The kernel's forward (g None) or backward, float32, in its order."""
    b, h, n, _ = scores.shape
    key = layout(n)
    t, v = key.shape[:2]
    flat = key.clamp(min=0).reshape(-1)
    cells = lambda x, shape: x[..., flat].reshape(*shape, t, v, 4)
    qm = mask.reshape(b, 1, n, 1, 1, 1)
    live = (cells(mask, (b, 1, 1)) > 0) & (key >= 0)
    p = torch.ones((b, 1, n, t, v, 4))
    if pe is not None:
        p = p * cells(pe[:, None], (b, 1, n))
    if deg is not None:
        p = p * cells(deg[:, None, None], (b, 1, 1))
    p = torch.where(live, p, 0.0)
    x = cells(scores, (b, h, n))
    m = torch.where(live, x, NEG_INF).amax((-3, -2, -1), keepdim=True)
    e = torch.where(live, torch.exp(x - m), 0.0)
    se = thread_sum(e)
    sp = thread_sum(e * p).double()
    col = lambda s: team_sum(s).float()[..., None, None, None]
    se, sp = col(se), col(sp)
    on = sp.abs() > EPS * se
    div = torch.where(on, sp, se)
    y = 1.0 / div
    keep = live & (qm != 0)
    if g is None:
        attn = torch.where(on, div_rn(e * p, div, y), div_rn(e, div, y) * p)
        return scatter(torch.where(keep, attn * qm, 0.0), key)
    gm = cells(g, (b, h, n)) * qm
    w = div_rn(torch.where(on, e * p, e), div, y)
    c = torch.where(on, gm, gm * p)
    rho = torch.zeros((b, h, n, t), dtype=torch.float64)
    for vi in range(v):
        for q in range(4):
            rho = rho + (c[..., vi, q] * w[..., vi, q]).double()
    return scatter(torch.where(keep, w * (c - col(rho)), 0.0), key)


def scatter(out, key):
    """Cells [B, H, N, T, V, 4] of the layout `key` into rows [B, H, N, N]."""
    b, h, n = out.shape[:3]
    full = torch.zeros((b, h, n, n))
    valid = (key >= 0).reshape(-1)
    full[..., key.reshape(-1)[valid]] = out.reshape(b, h, n, -1)[..., valid]
    return full


def max_err(got, want):
    return float((got.double() - want).abs().max())


# (B, H, N, padding, pe and degree given): chip_smoke's `modulation_inputs`
# (graph i loses its last pad + i mod 8 nodes, pe 0 on graph 0's first 4
# query rows); at N = 1 graph 1 loses its one node
CASES = [(3, 2, 1, 0, True), (3, 3, 17, 2, True), (3, 4, 48, 11, True),
         (2, 3, 128, 17, False), (1, 1, 2048, 100, True)]


@pytest.mark.parametrize("b,h,n,pad,with_mod", CASES)
def test_modulation_tiles_keep_f32_accuracy(b, h, n, pad, with_mod):
    scores, pe, deg, mask, g = chip_smoke.modulation_inputs(
        b + n, b, h, n, pad, torch.device("cpu"))
    if not with_mod:
        pe = deg = None
    args = [scores, pe, deg, mask]
    a64 = [None if x is None else x.double() for x in args]
    dead = chip_smoke.masked_cells(mask).expand_as(scores)
    for name, extra in (("fwd", []), ("bwd", [g])):
        got = emulate(*args, *extra)
        plain = getattr(tmod, f"modulation_{name}_plain")
        want32 = plain(*args, *extra)
        want = plain(*a64, *[x.double() for x in extra])
        assert torch.isfinite(got).all()
        assert torch.allclose(got, want32, **KERNEL_TOL), name
        assert bool((got[dead] == 0).all())
        e_k, e_c = max_err(got, want), max_err(want32, want)
        assert e_k <= CPU32_FACTOR * e_c, (name, e_k, e_c)


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(jmod.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))


def zero_case(seed=4, b=3, h=2, n=12):
    """Scores, a mask with graph 0 padded, graph 1 all masked and graph 2
    whole, pe and degree over the real nodes, and a cotangent."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, n), bool)
    mask[0, n - 5:] = False
    mask[1] = False
    pe = (rng.random((b, n, n)) * mask[:, :, None]
          * mask[:, None, :]).astype(np.float32)
    deg = (rng.random((b, n)) * mask).astype(np.float32)
    f = lambda: rng.standard_normal((b, h, n, n)).astype(np.float32)
    return f(), mask, pe, deg, f()


@pytest.mark.parametrize("side", ["jax", "port"])
def test_masked_cells_are_exactly_zero(side, interpret_mode):
    scores, mask, pe, deg, g = zero_case()
    if side == "jax":
        fn = lambda s: jmod.fused_modulated_attention(
            s, jnp.asarray(mask), pe=jnp.asarray(pe), degree=jnp.asarray(deg))
        out, vjp = jax.vjp(fn, jnp.asarray(scores))
        outs = [np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])]
    else:
        t = lambda a: torch.from_numpy(a)
        fm = t(mask).float()
        outs = [tmod.modulation_fwd(t(scores), t(pe), t(deg), fm).numpy(),
                tmod.modulation_bwd(t(scores), t(pe), t(deg), fm,
                                    t(g)).numpy()]
    dead = ~(mask[:, None, :, None] & mask[:, None, None, :])
    dead = np.broadcast_to(dead, scores.shape)
    for out in outs:
        assert np.isfinite(out).all()
        assert (out[dead] == 0).all()
        assert (out[~dead] != 0).mean() > 0.9


def test_modulation_cost_counts_what_the_mask_needs():
    """Two graphs of N = 5 with 3 and 0 real nodes, H = 2: the scores of
    the 9 real cells a head, every one of the 2 * 25 output cells a head,
    pe at the 9 real cells, the degree of the 3 real nodes and the whole
    mask (10 floats); then one graph of 4 real nodes, where every cell is
    read."""
    mask = torch.tensor([[1, 1, 0, 1, 0], [0] * 5], dtype=torch.float32)
    ops, nbytes = chip_smoke.modulation_cost(mask, 2, "fwd")
    assert (ops, nbytes) == (10.0 * 2 * 9,
                             4.0 * (2 * 9 + 2 * 50 + 9 + 3 + 10))
    ops, nbytes = chip_smoke.modulation_cost(mask, 2, "bwd")
    assert (ops, nbytes) == (20.0 * 2 * 9,
                             4.0 * (2 * 2 * 9 + 2 * 50 + 9 + 3 + 10))
    every = torch.ones(1, 4)              # one graph of 4 real nodes, H = 1
    _, nbytes = chip_smoke.modulation_cost(every, 1, "bwd")
    assert nbytes == 4.0 * (2 * 16 + 16 + 16 + 4 + 4)
