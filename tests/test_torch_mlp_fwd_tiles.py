"""The arithmetic of the fused MLP's forward, emulated on the CPU.

`csrc/fused_mlp.cu`'s forward keeps a slab of hidden units' W1, W2 and b1
in shared memory and walks strips of rows on the tensor cores. No card is
needed to check that its arithmetic keeps float32 accuracy: it is emulated
here in torch, step by step in the kernel's order: x split as
`test_torch_tf32_split.py` splits (`tc::split`), the weights and h by
`split_t` (lo's 13 low bits dropped, not rounded), each 3xTF32 product's
terms lo·hi, hi·lo, hi·hi into a fresh fragment. The geometry (units a
slab, warps a group, m-tiles a strip, the run length) is read from the
source.

Per 8-unit k-step of a warp: pre = b1 + x W1, a fresh 3xTF32 fragment per
8-deep k-step of d_in added in order; h = relu(pre), or 0 where the keep
bit of `dropout_keep` drops the unit; y's run += h W2, a fresh fragment
per k-step; every 8 k-steps the run into the warp's total. A group's four
warps each take a quarter of the slab's k-steps, and their totals are
added in warp order, then times 1 / (1 - rate); one slab gives y + b2,
more give partials added in slab order in runs of 8, then b2. At R = 300,
d 8 (one slab) and 20 (the 32 bucket: two slabs, the second of 8 units),
F = 520 (not a multiple of a slab or of a run), dropout 0 and 0.1, on
`chip_smoke.mlp_inputs`: within rtol 1e-4 / atol 1e-5 of
`fused_mlp_plain` and of float64, y's error from float64 within 2x the
CPU float32 route's, and at rate 0 within the same tolerance of the JAX
`_fwd_kernel` in interpret mode.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.experimental.pallas as pl
import jax.numpy as jnp

import chip_smoke
from feta_tmlr_tpu.ops.pallas import fused_mlp as jfm
from feta_tmlr_tpu_torch.ops.kernels import fused_mlp as tfm
from test_torch_fused_tiles import padded
from test_torch_tf32_split import RUN_TILES, run_sum, split, tf32_rna

KERNEL_TOL = chip_smoke.KERNEL_TOL          # rtol 1e-4, atol 1e-5
CPU32_FACTOR = chip_smoke.FUSED_CPU32_FACTOR
SOURCE = Path(tfm.__file__).resolve().parents[2] / "csrc" / "fused_mlp.cu"


def constant(name):
    """An integer `constexpr int name = value;` of the source."""
    text = SOURCE.read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def fwd_geometry(d):
    """(units a slab, warps a group, m-tiles a strip) of fwd_kernel<D>."""
    text = SOURCE.read_text()
    body = text[text.index("struct Fwd {"):]
    mt = re.search(r"MT = D <= (\d+) \? (\d+) : (\d+);", body)
    m_tiles = int(mt.group(2) if d <= int(mt.group(1)) else mt.group(3))
    return (constant("kSlabFloats") // (2 * d), constant("kGroupWarps"),
            m_tiles)


def bucket(din, dout):
    return next(b for b in (8, 16, 32, 64) if max(din, dout) <= b)


def split_t(x):
    """fused_mlp.cu's split_t as the tensor cores read it: hi = x rounded
    to TF32 (`tc::split`'s), lo = x - hi with its 13 low bits dropped."""
    hi = tf32_rna(x)
    lo = (x - hi).contiguous().view(torch.int32) & -0x2000
    return hi, lo.view(torch.float32)


def fresh(a, b, split_a=split_t):
    """a @ b (K = 8) as one 3xTF32 product into a fresh fragment: the
    terms lo·hi, hi·lo, hi·hi in order, each an exact sum (float64)
    rounded once into the f32 fragment; b split by split_t."""
    (ah, al), (bh, bl) = split_a(a), split_t(b)
    part = torch.zeros((a.shape[0], b.shape[1]))
    for u, v in ((al, bh), (ah, bl), (ah, bh)):
        part = (part.double() + u.double() @ v.double()).float()
    return part


def mlp_fwd_emulated(x, w1, b1, w2, b2, rate, seed):
    """fwd_kernel<D> and fwd_finish_kernel in torch: y [R, d_out]."""
    r, din = x.shape
    f, dout = w2.shape
    d = bucket(din, dout)
    units, group_warps, _ = fwd_geometry(d)
    run_steps = constant("kRunTerms")
    keep = torch.ones((r, f))
    if rate > 0:
        keep = tfm.dropout_keep(seed, r, f, rate).float()
    xp = padded(x, d)
    parts = []
    for j0 in range(0, f, units):
        nu = min(units, f - j0)
        nks = -(-nu // 8)
        w1s = padded(w1[:, j0:j0 + nu], d, 8 * nks)
        w2s = padded(w2[j0:j0 + nu], 8 * nks, d)
        b1s = padded(b1[j0:j0 + nu], 8 * nks)
        kp = padded(keep[:, j0:j0 + nu], 8 * nks)
        kpw = -(-nks // group_warps)
        slab = None
        for w in range(group_warps):
            kb = min(nks, w * kpw)
            tot, run = torch.zeros((r, d)), torch.zeros((r, d))
            for ks in range(kb, min(nks, kb + kpw)):
                us = slice(8 * ks, 8 * ks + 8)
                pre = b1s[us].expand(r, 8)
                for c in range(0, d, 8):
                    pre = pre + fresh(xp[:, c:c + 8], w1s[c:c + 8, us],
                                      split)
                h = torch.relu(pre) * kp[:, us]
                run = run + fresh(h, w2s[us])
                if (ks - kb) % run_steps == run_steps - 1:
                    tot, run = tot + run, torch.zeros_like(run)
            tot = tot + run
            slab = tot if slab is None else slab + tot
        if rate > 0:
            slab = slab * tfm._inv_keep(rate)
        parts.append(slab[:, :dout])
    y = parts[0] if len(parts) == 1 else run_sum(parts)
    return y + b2


def max_err(got, want):
    return float((got.double() - want.double()).abs().max())


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(jfm.pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))


@pytest.mark.parametrize("d", [8, 20])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_mlp_fwd_tiles_keep_f32_accuracy(interpret_mode, d, rate):
    x, w1, b1, w2, b2, _ = chip_smoke.mlp_inputs(d, 300, d, 520, d, "cpu")
    got = mlp_fwd_emulated(x, w1, b1, w2, b2, rate, 11)
    plain = tfm.fused_mlp_plain(x, w1, b1, w2, b2, rate, 11)
    want = tfm.fused_mlp_plain(*(t.double() for t in (x, w1, b1, w2, b2)),
                               rate, 11)
    assert got.shape == plain.shape
    assert torch.allclose(got, plain, **KERNEL_TOL)
    assert torch.allclose(got.double(), want, **KERNEL_TOL)
    assert max_err(got, want) <= CPU32_FACTOR * max_err(plain, want), (
        max_err(got, want), max_err(plain, want))
    if rate == 0.0:
        jy = jfm.fused_mlp(*(jnp.asarray(t.numpy())
                             for t in (x, w1, b1, w2, b2)), block_rows=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(jy),
                                   **KERNEL_TOL)


def test_mlp_fwd_geometry_covers_every_row_and_unit():
    """Each slab's k-steps split over a group's warps cover the slab once,
    runs are RunSum's length, and `launch_fwd`'s rows per group (whole
    m-tiles, a block an SM) cover R, at the SAN shape and ragged ones."""
    assert constant("kRunTerms") == RUN_TILES
    groups = constant("kFwdThreads") // 32 // constant("kGroupWarps")
    for r, f, d in ((40960, 2048, 8), (10007, 2048, 8), (300, 520, 32),
                    (1, 70, 64), (31, 2048, 16)):
        units, group_warps, m_tiles = fwd_geometry(d)
        slabs = -(-f // units)
        assert slabs * units >= f > (slabs - 1) * units
        seen = torch.zeros(slabs * units // 8, dtype=torch.int64)
        for sl in range(slabs):
            nks = -(-min(units, f - sl * units) // 8)
            kpw = -(-nks // group_warps)
            for w in range(group_warps):
                kb = min(nks, w * kpw)
                seen[sl * units // 8 + kb:
                     sl * units // 8 + min(nks, kb + kpw)] += 1
        assert bool((seen[:-(-f // 8)] == 1).all())
        n_groups = -(-132 // slabs) * groups
        rows = -(-(-(-r // n_groups)) // 16) * 16
        assert rows % 16 == 0 and -(-r // rows) <= n_groups
        assert m_tiles in (1, 2)
