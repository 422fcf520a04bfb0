#!/usr/bin/env python3
"""Drive the PyTorch port of FeTA on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. environment: torch version, the card's name and power limit; TF32 off
     for matmuls and cuDNN, so every float32 product is full float32;
  2. build the CUDA kernels from `feta_tmlr_tpu_torch/csrc/` (one nvcc per
     source, all started together) and print the build seconds;
  3. hold each kernel against its plain PyTorch version on the card, at the
     slices' shapes, printing the largest absolute error, the kernel's and
     the plain version's median milliseconds (CUDA events) and the bound:
     the attention kernels at H=8, N=1024, D=64, value widths 64 and 8
     (B=4, the training batch, and B=8, the serving batch) and at a ragged
     N=200 with B=8, with padded nodes, the backward kernels also on rows
     in the |su/se| <= 1e-9 branch; the fused-MLP kernels at the SAN
     eigen-PE head's 40,960 rows (d 8, F 2048) and at a ragged 10,007, at
     dropout 0 and 0.1, with their masks read back bit-equal to the plain
     version's, a keep fraction of 0.9 +- 0.002 and two backward runs
     bit-identical;
  4. serve the FeTA SBM node classifier (DiffGraphTransformerGenGCNSBM at
     d_model 64, 8 heads, 10 layers, ff 128, batch norm, LapPE 8, Chebyshev
     order 4; random weights from a seed) at N=1024 through `Predictor` on
     CUDA: four requests (8, 8, 8 and 5 graphs), launch counts read around
     them, logits of two graphs held against the CPU path;
  5. train the same model on the same 8 graphs through `Trainer` on CUDA:
     2 batches of 4 graphs, 3 epochs of AdamW (6 steps, warmup towards lr
     1e-3) with finite and falling loss, then a timed window of 20 more
     epochs (40 steps: ms per step over the window with its spread, and
     each epoch's process CPU time, garbage-collection time and new device
     memory segments); launch counts per step over all 46 steps; acc_sbm;
     no host sync in one more step (torch's sync debug mode);
     then one step from the same initial weights on CUDA,
     on the CPU in float32 and on the CPU in float64, the CUDA loss and
     gradients held to the float64 ones;
  6. serve SAN_NodeSpectra (ZINC: hidden 56, 8 heads, 10 layers, eigen-PE
     head of dim 8, 4 heads, 2 layers, ff 2048 over m=10 frequencies,
     typed bond edges, batch norm, Chebyshev order 4 in every layer) through
     `Predictor`: four requests of 128 ZINC-shaped graphs padded to 32
     nodes, 2 fused-MLP forward launches each, 8 graphs held against the
     CPU path;
  7. train it through `Trainer` (graph_reg, L1): 2 batches of 128 graphs,
     3 epochs warming up towards lr 7e-4 (weight decay 0, FreqTransformer
     dropout 0.1, eigvec sign flip on), then a timed window of 10 epochs;
     2 + 2 fused-MLP launches per step, finite loss, no host sync in a
     step (torch's sync debug mode); the eigen-PE dropout mask's device
     and host time and kernel count; then one step on 16 graphs with that
     dropout at 0, CUDA against the CPU in float64;
  8. print the kernels' JSON line, the card line, and the final status line
     `{"ok": true, "device": {...}}`.

`--profile` adds torch.profiler breakdowns of one request's and one
training step's device time, for each model. It needs one card and exits non-zero without
printing a result when CUDA is unavailable.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from feta_tmlr_tpu_torch.data.batch import collate_graphs
from feta_tmlr_tpu_torch.data.synthetic import (
    sbm_like_dataset,
    zinc_categorical_dataset,
)
from feta_tmlr_tpu_torch.nn.layers import MaskedBatchNorm
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformerGenGCNSBM
from feta_tmlr_tpu_torch.nn.san import SANNodeSpectra, hash_dropout
from feta_tmlr_tpu_torch.ops.kernels import build
from feta_tmlr_tpu_torch.ops.kernels import colstat as cs_mod
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as fl_mod
from feta_tmlr_tpu_torch.ops.kernels import fused_mlp as fm_mod
from feta_tmlr_tpu_torch.ops.kernels.common import bwd_row_constants
from feta_tmlr_tpu_torch.pe.encodings import DiffusionEncoding, LapEncoding
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp
from feta_tmlr_tpu_torch.serve import Predictor
from feta_tmlr_tpu_torch.train.trainer import TrainConfig, Trainer

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES = 3.35e12            # HBM3
KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)   # f32, sums in another order
SLICE_TOL = dict(rtol=1e-3, atol=1e-3)    # 10 f32 layers, CUDA vs CPU
# one training step on CUDA (float32) vs the CPU route in float64: loss
# within rtol 1e-5; each named gradient within 1e-2 of its largest entry.
# From random weights the gradients reach |g| ~ 40 through 10 layers at
# N=1024, and f32 rounding in the forward is amplified on the way back; the
# CPU's own float32 route is printed beside it for scale.
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_REL = 1e-2
STEP_PARAMS = ("encoder.layers.0.qkv", "encoder.layers.9.qkv",
               "encoder.layers.9.out_proj_kernel",
               "encoder.coeff_head.gcn_kernel", "classifier.fc2.weight")
MODEL_CFG = dict(in_size=3, nb_class=2, d_model=64, nb_heads=8,
                 dim_feedforward=128, dropout=0.0, nb_layers=10,
                 batch_norm=True, lap_pos_enc=True, lap_pos_enc_dim=8,
                 filter_order=4)
N_NODES = 1024
N_GRAPHS = 8
TRAIN_EPOCHS = 3
TIMED_EPOCHS = 20
# kernel checks: (B, N, padding); the JSON rows are those of the first
# shape, the training batch, whose steps make most of the counted launches
CHECK_SHAPES = ((N_GRAPHS // 2, N_NODES, 60), (N_GRAPHS, N_NODES, 60),
                (N_GRAPHS, 200, 9))
# the wrappers whose launches a run counts, and their launches per step
KERNELS = {"flash_fwd": fl_mod.flash_fwd, "colstat": cs_mod.colstat,
           "flash_bwd_q": fl_mod.flash_bwd_q,
           "flash_bwd_k": fl_mod.flash_bwd_k,
           "fused_mlp_fwd": fm_mod.fused_mlp_fwd,
           "fused_mlp_bwd": fm_mod.fused_mlp_bwd}
NONE = dict.fromkeys(KERNELS, 0)
STEP_LAUNCHES = {**NONE, "flash_fwd": 10, "colstat": 2, "flash_bwd_q": 10,
                 "flash_bwd_k": 10}
# SAN_NodeSpectra at configs/LPE/ZINC/optimized.json's net params under the
# mean readout (bench_tiers.py:210-215; full graph, batch norm, residuals,
# layer dropout 0 and the filter in every layer are the port's only
# variant): FreqTransformer ff 2048, dropout 0.1; batches of 128
# ZINC-shaped graphs padded to 32 nodes, m = 10 eigen-frequencies, so the
# fused MLP sees 128 * 32 * 10 = 40,960 rows
SAN_CFG = dict(num_atom_type=28, num_bond_type=4, hidden_dim=56, out_dim=56,
               n_heads=8, n_layers=10, lpe_dim=8, lpe_heads=4, lpe_layers=2,
               gamma=1e-5, filter_order=4, n_out=1)
SAN_GRAPHS = 128
SAN_NODES = 32
SAN_FREQS = 10
SAN_ROWS = SAN_GRAPHS * SAN_NODES * SAN_FREQS
SAN_REQUESTS = 4
SAN_TRAIN_EPOCHS = 3
SAN_TIMED_EPOCHS = 10
SAN_STEP_LAUNCHES = {**NONE, "fused_mlp_fwd": 2, "fused_mlp_bwd": 2}
SAN_STEP_PARAMS = ("embedding_h.weight", "layers.0.attention.Q.weight",
                   "layers.9.attention.E.weight", "layers.9.cheb_weight",
                   "pe_transformer.freq_transformer.ff1_0.kernel",
                   "pe_transformer.freq_transformer.ff2_1.kernel",
                   "mlp_readout.fc_out.weight")
# fused-MLP checks: (rows, d_in, F, d_out); the JSON rows are those of the
# first shape at dropout 0.1, the training path's
MLP_SHAPES = ((SAN_ROWS, 8, 2048, 8), (10007, 8, 2048, 8))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25) -> float:
    """Median milliseconds of one call, CUDA events around each call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(seed, b, h, n, d, dv, pad, device):
    """Public-layout attention operands from numpy, as the layer makes
    them; the last `pad`..`pad + b` nodes of each graph are padding."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = np.ones((b, n), bool)
    for i in range(b):
        mask[i, n - pad - i:] = False
    pe = (rng.random((b, n, n)) * mask[:, :, None]
          * mask[:, None, :]).astype(np.float32)
    deg = (rng.random((b, n)) * mask).astype(np.float32)
    arrays = dict(xa=0.3 * f(b, h, n, d), x=0.3 * f(b, n, d), cq=f(b, n, h),
                  ck=f(b, n, h), c0=f(h), node_mask=mask, pe=pe,
                  degree=deg)
    ops = fl_mod.prepare(**{k: torch.from_numpy(v).to(device)
                            for k, v in arrays.items()})
    vw = torch.from_numpy(f(b, h, n, dv)).to(device)
    return ops, vw


def max_err(got, want, name):
    """Largest absolute error; raise where |got - want| > atol + rtol|want|."""
    worst = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite output")
        worst = max(worst, float((g - w).abs().max()))
        if not torch.allclose(g, w, **KERNEL_TOL):
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"(max abs err {worst:.3e})")
    return worst


def flash_cost(b, h, n, d, dv):
    flops = 2.0 * b * h * n * n * (d + dv)
    nbytes = 4.0 * (b * h * n * d + b * n * d + b * h * n * dv + b * n * n
                    + 2 * b * n + 2 * b * h * n + h
                    + b * h * n * dv + 3 * b * h * n)
    return flops, nbytes


def colstat_cost(b, h, n, d):
    flops = 2.0 * b * h * n * n * d
    nbytes = 4.0 * (b * h * n * d + b * n * d + b * n * n + 2 * b * n
                    + 2 * b * h * n + h + 4 * b * h * n + 2 * b * h * n)
    return flops, nbytes


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def check_kernels(device, h=8, d=64, shapes=CHECK_SHAPES):
    """Phase 3: each kernel vs its plain version; returns the JSON rows
    (numbers of the first shape at dv=64, errors over all shapes)."""
    rows = {}
    errs = {"flash_fwd": 0.0, "colstat": 0.0}
    for b, n, pad in shapes:
        for dv in (64, 8):
            ops, vw = attention_inputs(b + n + dv, b, h, n, d, dv, pad,
                                       device)
            with torch.inference_mode():
                got = fl_mod.flash_fwd(vw=vw, **ops)
                want = fl_mod.flash_fwd_plain(vw=vw, **ops)
                torch.cuda.synchronize()
                e1 = max_err(got, want, f"flash_fwd N={n} dv={dv}")
                stats = dict(m=want[1], se=want[2], su=want[3])
                wq = torch.rand(want[2].shape, device=device,
                                generator=torch.Generator(device).manual_seed(n))
                e2 = 0.0
                for w in (None, wq):
                    e2 = max(e2, max_err(
                        cs_mod.colstat(**ops, **stats, wq=w),
                        cs_mod.colstat_plain(**ops, **stats, wq=w),
                        f"colstat N={n} wq={'dis' if w is not None else 1}"))
                torch.cuda.synchronize()
                t_k = time_ms(lambda: fl_mod.flash_fwd(vw=vw, **ops))
                t_p = time_ms(lambda: fl_mod.flash_fwd_plain(vw=vw, **ops))
                c_k = time_ms(lambda: cs_mod.colstat(**ops, **stats, wq=wq))
                c_p = time_ms(lambda: cs_mod.colstat_plain(**ops, **stats,
                                                           wq=wq))
            errs["flash_fwd"] = max(errs["flash_fwd"], e1)
            errs["colstat"] = max(errs["colstat"], e2)
            fb, fby = bound(*flash_cost(b, h, n, d, dv))
            cb, cby = bound(*colstat_cost(b, h, n, d))
            print(f"kernel check B={b} H={h} N={n} D={d} dv={dv} pad~{pad}: "
                  f"flash_fwd err {e1:.3e} {t_k:.4f} ms (plain {t_p:.4f} ms,"
                  f" bound {fb:.4f} ms {fby}); colstat err {e2:.3e} "
                  f"{c_k:.4f} ms (plain {c_p:.4f} ms, bound {cb:.4f} ms "
                  f"{cby}); tolerance rtol 1e-4 atol 1e-5", flush=True)
            if (b, n, pad) == shapes[0] and dv == 64:
                rows["flash_fwd"] = dict(ms=t_k, plain_ms=t_p, bound_ms=fb,
                                         bound_by=fby)
                rows["colstat"] = dict(ms=c_k, plain_ms=c_p, bound_ms=cb,
                                       bound_by=cby)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    return rows


def bwd_cost(b, h, n, d, dv, which):
    """(flops, bytes) of one backward pass: each input read once (the
    forward's operands, g and five row constants), each output written
    once (q: dxa, dcq; k: dvw, dck, dx)."""
    inputs = (b * h * n * d + b * n * d + 2 * b * h * n + h + b * n * n
              + 2 * b * n + 2 * b * h * n * dv + 5 * b * h * n)
    if which == "q":
        return (2.0 * b * h * n * n * (2 * d + dv),
                4.0 * (inputs + b * h * n * d + b * h * n))
    return (2.0 * b * h * n * n * (2 * d + 2 * dv),
            4.0 * (inputs + b * h * n * dv + b * h * n + b * n * d))


def bwd_inputs(seed, b, h, n, d, dv, pad, device, guard_rows=8):
    """Backward operands: the attention inputs with pe zero on the first
    `guard_rows` (real) query rows of graph 0, so su = 0 there and those
    rows take the |su/se| <= 1e-9 branch (beta = 0; c = r = 0 as outh = 0);
    the forward statistics from the plain version; a random cotangent; su
    zeroed on `guard_rows` further real rows of graph 1, so the branch also
    runs with c = r != 0; and the row constants."""
    ops, vw = attention_inputs(seed, b, h, n, d, dv, pad, device)
    ops["pe"][0, :guard_rows] = 0.0
    outh, m, se, su = fl_mod.flash_fwd_plain(vw=vw, **ops)
    g = torch.randn(outh.shape, device=device,
                    generator=torch.Generator(device).manual_seed(seed))
    su[1, :, :guard_rows] = 0.0
    consts = bwd_row_constants(g, outh, se, su, ops["mask"])
    n_guard = int(((su / se).abs() <= 1e-9).logical_and(
        ops["mask"][:, None] > 0).sum())
    args = (ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"], vw,
            ops["pe"], ops["deg"], ops["mask"], ops["inv_sqrt"], g, m,
            *consts)
    return args, n_guard, int((consts[3] != 0).sum())


def check_bwd_kernels(device, h=8, d=64, shapes=CHECK_SHAPES):
    """Phase 3, backward: flash_bwd_q / flash_bwd_k vs their plain
    versions; returns the JSON rows like `check_kernels`."""
    rows = {}
    errs = {"flash_bwd_q": 0.0, "flash_bwd_k": 0.0}
    passes = {"flash_bwd_q": (fl_mod.flash_bwd_q, fl_mod.flash_bwd_q_plain),
              "flash_bwd_k": (fl_mod.flash_bwd_k, fl_mod.flash_bwd_k_plain)}
    for b, n, pad in shapes:
        for dv in (64, 8):
            args, n_guard, n_c = bwd_inputs(b + n + dv + 1, b, h, n, d, dv,
                                            pad, device)
            line = [f"backward check B={b} H={h} N={n} D={d} dv={dv} "
                    f"pad~{pad}: {n_guard} rows in the guard branch, {n_c} "
                    f"with c != 0"]
            with torch.inference_mode():
                for name, (kernel, plain) in passes.items():
                    got, want = kernel(*args), plain(*args)
                    torch.cuda.synchronize()
                    outs = ("dxa", "dcq") if name.endswith("q") else (
                        "dvw", "dck", "dx")
                    each = [max_err([g_], [w_], f"{name} {o} N={n} dv={dv}")
                            for o, g_, w_ in zip(outs, got, want)]
                    errs[name] = max(errs[name], *each)
                    t_k = time_ms(lambda: kernel(*args))
                    t_p = time_ms(lambda: plain(*args))
                    bnd, by = bound(*bwd_cost(b, h, n, d, dv, name[-1]))
                    line.append(
                        f"{name} err " + " ".join(
                            f"{o} {e:.3e}" for o, e in zip(outs, each))
                        + f"; {t_k:.4f} ms (plain {t_p:.4f} ms, bound "
                        f"{bnd:.4f} ms {by})")
                    if (b, n, pad) == shapes[0] and dv == 64:
                        rows[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=bnd,
                                          bound_by=by)
            print("; ".join(line) + "; tolerance rtol 1e-4 atol 1e-5",
                  flush=True)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    return rows


def mlp_inputs(seed, r, din, f, dout, device, g_scale=0.005):
    """x, w1, b1, w2, b2 at the scales of the model's initializers
    (lecun-normal weights) and a cotangent g of scale `g_scale`; the
    default is the scale the L1 loss's mean over 128 graphs gives (|g| <
    1e-2): dW2 and db2 sum R = 40,960 terms, and at g ~ 0.05 their f32
    rounding alone reaches 3e-5 on both sides (against float64), above
    atol 1e-5 on entries near zero.

    x, w1 and b1 lie on dyadic grids (steps 2^-3, 2^-6, 2^-9), so that
    pre = x w1 + b1 is exact in f32 in any summation order. The relu's
    derivative jumps at 0: an f32 pre within rounding of 0 (a few of the
    84M units at R = 40,960) would take another branch in the kernel than
    in cuBLAS and move dx and dW1 by ~1e-2, whatever the kernel's
    accuracy."""
    rng = np.random.default_rng(seed)
    t = lambda scale, *s: torch.from_numpy(
        (scale * rng.standard_normal(s)).astype(np.float32)).to(device)
    grid = lambda step, a: torch.round(a / step) * step
    return (grid(2 ** -3, t(1.0, r, din)).clamp(-4, 4),
            grid(2 ** -6, t(din ** -0.5, din, f)), grid(2 ** -9, t(0.1, f)),
            t(f ** -0.5, f, dout), t(0.1, dout), t(g_scale, r, dout))


def mlp_cost(r, din, f, dout, which):
    """(flops, bytes) of one call: the forward's two products, or the
    backward's five (g W2^T, dx, dW1, dW2 and the recomputed x W1); each
    input read once, each output written once."""
    weights = din * f + f + f * dout
    if which == "fwd":
        return (2.0 * r * f * (din + dout),
                4.0 * (r * din + weights + dout + r * dout))
    return (2.0 * r * f * (3 * din + 2 * dout),
            4.0 * (r * din + weights + r * dout + r * din + weights + dout))


def mlp_masks(device, seed, rate, rows, units=64):
    """The keep masks the kernels apply, read back exactly: with x = 0 and
    b1 = 1 every unit is live with h = scale, so w2 = I makes the
    forward's y = scale ([rows, units]), and g = I over the first `units`
    rows makes the backward's dW2[j, r] = scale[r, j]."""
    x = torch.zeros(rows, 1, device=device)
    w1 = torch.zeros(1, units, device=device)
    b1 = torch.ones(units, device=device)
    eye = torch.eye(units, device=device)
    with torch.no_grad():
        y = fm_mod.fused_mlp_fwd(x, w1, b1, eye,
                                 torch.zeros(units, device=device), rate,
                                 seed)
        dw2 = fm_mod.fused_mlp_bwd(x[:units], w1, b1, eye, eye, rate, seed)[3]
    return y > 0, dw2.T > 0


def check_fused_mlp(device, shapes=MLP_SHAPES, seed=7):
    """Phase 3, fused MLP: forward and backward kernels vs their plain
    versions at rate 0 and 0.1; two backward runs bit-identical; the
    kernels' dropout masks bit-equal to the plain version's and keeping
    0.9 +- 0.002 of the units. Returns the JSON rows like
    `check_kernels`."""
    rows = {}
    errs = {"fused_mlp_fwd": 0.0, "fused_mlp_bwd": 0.0}
    for r, din, f, dout in shapes:
        x, w1, b1, w2, b2, g = mlp_inputs(r + f, r, din, f, dout, device)
        for rate in (0.0, 0.1):
            with torch.no_grad():
                fwd = lambda: fm_mod.fused_mlp_fwd(x, w1, b1, w2, b2, rate,
                                                   seed)
                bwd = lambda: fm_mod.fused_mlp_bwd(x, w1, b1, w2, g, rate,
                                                   seed)
                plain_f = lambda: fm_mod.fused_mlp_plain(x, w1, b1, w2, b2,
                                                         rate, seed)
                plain_b = lambda: fm_mod.fused_mlp_bwd_plain(x, w1, b1, w2,
                                                             g, rate, seed)
                got_f, got_b, again = fwd(), bwd(), bwd()
                torch.cuda.synchronize()
                tag = f"R={r} rate={rate}"
                e_f = max_err([got_f], [plain_f()], f"fused_mlp_fwd {tag}")
                e_b = max_err(got_b, plain_b(), f"fused_mlp_bwd {tag}")
                if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
                    raise AssertionError(f"fused_mlp_bwd {tag}: two runs "
                                         "differ")
                times = [time_ms(fn) for fn in (fwd, bwd, plain_f, plain_b)]
            errs["fused_mlp_fwd"] = max(errs["fused_mlp_fwd"], e_f)
            errs["fused_mlp_bwd"] = max(errs["fused_mlp_bwd"], e_b)
            bf = bound(*mlp_cost(r, din, f, dout, "fwd"))
            bb = bound(*mlp_cost(r, din, f, dout, "bwd"))
            print(f"fused-MLP check R={r} d_in={din} F={f} d_out={dout} "
                  f"rate={rate}: fwd err {e_f:.3e} {times[0]:.4f} ms (plain "
                  f"{times[2]:.4f} ms, bound {bf[0]:.4f} ms {bf[1]}); bwd err "
                  f"{e_b:.3e} {times[1]:.4f} ms (plain {times[3]:.4f} ms, "
                  f"bound {bb[0]:.4f} ms {bb[1]}); two bwd runs bit-identical;"
                  f" tolerance rtol 1e-4 atol 1e-5", flush=True)
            if (r, din, f, dout) == shapes[0] and rate > 0:
                for name, t_k, t_p, (b_ms, by) in (
                        ("fused_mlp_fwd", times[0], times[2], bf),
                        ("fused_mlp_bwd", times[1], times[3], bb)):
                    rows[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                                      bound_by=by)
    keep_f, keep_b = mlp_masks(device, seed, 0.1, shapes[0][0])
    want = fm_mod.dropout_keep(seed, shapes[0][0], 64, 0.1, device)
    frac = float(keep_f.float().mean())
    if not (torch.equal(keep_f, want) and torch.equal(keep_b, want[:64])):
        raise AssertionError("fused-MLP dropout masks differ from the plain "
                             "version's")
    if abs(frac - 0.9) > 0.002:
        raise AssertionError(f"fused-MLP keep fraction {frac}")
    print(f"fused-MLP dropout 0.1: forward mask [{shapes[0][0]}, 64] and "
          f"backward mask [64, 64] bit-equal to the plain version's; keep "
          f"fraction {frac:.6f} (0.9 +- 0.002)", flush=True)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    return rows


def _pe_worker(graph):
    DiffusionEncoding(beta=1.0).apply_to([graph])
    LapEncoding(MODEL_CFG["lap_pos_enc_dim"]).apply_to([graph])
    return graph.pe, graph.lap_pe


def make_graphs():
    graphs = sbm_like_dataset(seed=2, n_graphs=N_GRAPHS, n_nodes=N_NODES)
    t0 = time.perf_counter()
    workers = max(1, min(len(graphs), os.cpu_count() or 1))
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        for g, (pe, lap_pe) in zip(graphs, pool.map(_pe_worker, graphs)):
            g.pe, g.lap_pe = pe, lap_pe
    print(f"host PE (diffusion beta=1 + LapPE 8) for {len(graphs)} graphs "
          f"of {min(g.num_nodes for g in graphs)}-"
          f"{max(g.num_nodes for g in graphs)} nodes: "
          f"{time.perf_counter() - t0:.1f} s on {workers} processes",
          flush=True)
    return graphs


def calibrate_batch_norm(model, batch, device):
    """Non-trivial running statistics, as training leaves them: one
    train-mode pass with momentum 0 sets every MaskedBatchNorm's running
    mean and variance to the masked statistics of its input on `batch`
    (random statistics instead would let activations grow layer by layer
    to magnitudes no trained model has)."""
    norms = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    for m in norms:
        m.momentum = 0.0
    model.train()
    with torch.no_grad():
        model(batch.to(device))
    model.eval()
    for m in norms:
        m.momentum = 0.9


def serve_slice(graphs, device, card, profile=False):
    """Phase 4: the port's serving path through Predictor on CUDA."""
    model = DiffGraphTransformerGenGCNSBM(**MODEL_CFG, seed=0, device=device)
    calibrate_batch_norm(model, collate_graphs(graphs, max_nodes=N_NODES,
                                               node_labels=True), device)
    cpu_model = copy.deepcopy(model).to("cpu")
    kw = dict(collate_kwargs={"max_nodes": N_NODES, "node_labels": True},
              node_level=True)
    pred = Predictor(model, device=device, max_batch=N_GRAPHS, **kw)
    requests = [graphs, graphs[3:] + graphs[:3], graphs[::-1], graphs[:5]]

    reset_launches()
    outs, call_ms = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(pred.predict(req))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    forwards = len(requests)
    if launches != {**NONE, "flash_fwd": 10 * forwards,
                    "colstat": 2 * forwards}:
        raise AssertionError(f"launch counts {launches} for {forwards} "
                             "forward batches; expected 10 and 2 per batch")

    for req, out in zip(requests, outs):
        if len(out) != len(req):
            raise AssertionError("a request lost graphs")
        for g, o in zip(req, out):
            if o.shape != (g.num_nodes, MODEL_CFG["nb_class"]) or \
                    not np.isfinite(o).all():
                raise AssertionError(f"bad logits {o.shape}")
    t0 = time.perf_counter()
    ref = Predictor(cpu_model, device="cpu", max_batch=2, **kw).predict(
        graphs[:2])
    cpu_s = time.perf_counter() - t0
    err = max(float(np.abs(o - r).max()) for o, r in zip(outs[0][:2], ref))
    for o, r in zip(outs[0][:2], ref):
        np.testing.assert_allclose(o, r, **SLICE_TOL)

    steady = statistics.median(call_ms[1:3])
    print(f"slice: {forwards} requests {[len(r) for r in requests]} at "
          f"N={N_NODES}; ms/call {[round(t, 2) for t in call_ms]}; "
          f"steady {steady:.2f} ms/call for {N_GRAPHS} graphs = "
          f"{N_GRAPHS / steady * 1e3:.1f} graphs/s on {card}", flush=True)
    scale = max(float(np.abs(r).max()) for r in ref)
    print(f"slice: launches {launches}; CUDA vs CPU logits of 2 graphs: max "
          f"abs err {err:.3e}, max |logit| {scale:.3f} (tolerance rtol 1e-3 "
          f"atol 1e-3; CPU path {cpu_s:.1f} s)", flush=True)
    if profile:
        profile_call(f"one request of {len(graphs)} graphs",
                     lambda: pred.predict(graphs))
    return launches


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


def timed_epochs(trainer, batches, epochs):
    """`epochs` more epochs of `trainer`: the epoch losses and, for each
    epoch, (host ms, this thread's CPU ms, the process's CPU ms over all
    its threads, garbage-collection ms, new device memory segments). The
    host clock ends in `train_epoch`'s host sync."""
    gc_ms, gc_t0 = [0.0], [0.0]

    def on_gc(phase, _info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_t0[0]) * 1e3

    segments = lambda: torch.cuda.memory_stats()["segment.all.allocated"]
    losses, rows = [], []
    gc.callbacks.append(on_gc)
    try:
        for _ in range(epochs):
            seg, gc0 = segments(), gc_ms[0]
            c0, p0 = time.thread_time(), time.process_time()
            t0 = time.perf_counter()
            losses.append(trainer.train_epoch(batches))
            rows.append(((time.perf_counter() - t0) * 1e3,
                         (time.thread_time() - c0) * 1e3,
                         (time.process_time() - p0) * 1e3,
                         gc_ms[0] - gc0, segments() - seg))
    finally:
        gc.callbacks.remove(on_gc)
    return losses, rows


def step_syncs(trainer, batch):
    """The host syncs of one `trainer.step` on a batch already on the
    card: the messages of torch's sync debug mode."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.step(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message).splitlines()[0] for w in caught
            if "called a synchronizing" in str(w.message)]


def dropout_cost(device):
    """One eigen-PE dropout mask at the training shape ([40,960, 8], rate
    0.1; a SAN step draws 4): its span on the card (CUDA events, median of
    25), the host ms to enqueue it (mean of 25, no sync), and its device
    kernels and their summed device time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    t = torch.ones(SAN_ROWS, SAN_CFG["lpe_dim"], device=device)
    gen = torch.Generator().manual_seed(0)
    fn = lambda: hash_dropout(t, 0.1, gen)
    dev_ms = time_ms(fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(25):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 25
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    print(f"san dropout mask [{SAN_ROWS}, {SAN_CFG['lpe_dim']}] rate 0.1: "
          f"span {dev_ms:.4f} ms, host enqueue {host_ms:.4f} ms, "
          f"{sum(e.count for e in rows)} device kernels busy {busy:.4f} ms "
          f"per mask; 4 masks per step", flush=True)


def train_slice(graphs, device, card, profile=False):
    """Phase 5: the port's training path through Trainer on CUDA, then one
    step from the same initial weights on CUDA and on the CPU."""
    model = DiffGraphTransformerGenGCNSBM(**MODEL_CFG, seed=1, device=device)
    initial = copy.deepcopy(model)
    per = N_GRAPHS // 2
    batches = [collate_graphs(graphs[i:i + per], max_nodes=N_NODES,
                              node_labels=True).to(device)
               for i in range(0, N_GRAPHS, per)]
    steps = TRAIN_EPOCHS * len(batches)
    # from random weights a constant lr of 1e-3 makes this 10-layer model's
    # loss rise over the first epochs, on the JAX trainer as on the port
    # (tests/test_torch_train.py::test_full_width_losses_jax_port_float64);
    # a linear warmup towards it over the first steps does not
    trainer = Trainer(model, TrainConfig(lr=1e-3, weight_decay=1e-5,
                                         sign_flip=True, seed=0,
                                         schedule="warmup",
                                         warmup_steps=steps))
    reset_launches()
    losses, first = timed_epochs(trainer, batches, TRAIN_EPOCHS)
    more, window = timed_epochs(trainer, batches, TIMED_EPOCHS)
    launches = read_launches()
    metric = trainer.evaluate(batches)
    syncs = step_syncs(trainer, batches[0])
    n_window = TIMED_EPOCHS * len(batches)
    per_step = [r[0] / len(batches) for r in window]
    mean = sum(r[0] for r in window) / n_window
    print(f"train: {steps} AdamW steps of {per} graphs at N={N_NODES} "
          f"(linear warmup towards lr 1e-3 over {steps} steps, weight decay "
          f"1e-5, dropout 0, sign flip on); epoch losses "
          f"{[round(x, 6) for x in losses]}; ms/epoch "
          f"{[round(r[0], 2) for r in first]}; process CPU ms/epoch "
          f"{[round(r[2], 2) for r in first]}; new device memory segments "
          f"per epoch {[r[4] for r in first]}", flush=True)
    print(f"train: timed window of {TIMED_EPOCHS} more epochs = {n_window} "
          f"steps (lr decaying as 1/sqrt(step) after the warmup): "
          f"{mean:.2f} ms/step over the window (all its steps over all its "
          f"time); per epoch ms/step median {statistics.median(per_step):.2f}"
          f", min {min(per_step):.2f}, max {max(per_step):.2f}, stdev "
          f"{statistics.stdev(per_step):.2f}; on {card}", flush=True)
    col = lambda i: [round(r[i], 2) for r in window]
    print(f"train: window ms/epoch {col(0)}; main thread CPU ms/epoch "
          f"{col(1)}; process CPU ms/epoch {col(2)}; gc ms/epoch {col(3)}; "
          f"new device memory segments {sum(r[4] for r in window)}; epoch "
          f"losses {[round(x, 6) for x in more]}", flush=True)
    total = steps + n_window
    print(f"train: acc_sbm {metric['acc_sbm']:.4f} on the training graphs "
          f"after {total} steps; launches {launches}; host syncs in one "
          f"step (sync debug mode): {len(syncs)} {syncs[:3]}", flush=True)
    if profile:
        profile_call(f"one training step of {per} graphs",
                     lambda: trainer.step(batches[0]))
    step_parity(initial, graphs[:2], device, "train",
                dict(max_nodes=N_NODES, node_labels=True),
                TrainConfig(regularization=0.1, sign_flip=False), STEP_PARAMS)
    want = {name: total * k for name, k in STEP_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"launch counts {launches} for {total} training "
                             f"steps; expected {STEP_LAUNCHES} per step")
    if syncs:
        raise AssertionError(f"an SBM training step syncs the host: {syncs}")
    if not all(np.isfinite(losses + more)) or not losses[-1] < losses[0]:
        raise AssertionError(f"epoch losses {losses}: not finite and falling")
    return launches


def make_san_graphs():
    """ZINC-shaped graphs with their eigen-PE: the requests' graphs first,
    then the two training batches (the first two requests' graphs)."""
    t0 = time.perf_counter()
    graphs = zinc_categorical_dataset(seed=3,
                                      n_graphs=SAN_REQUESTS * SAN_GRAPHS)
    apply_laplace_decomp(graphs, SAN_FREQS)
    sizes = [g.num_nodes for g in graphs]
    print(f"host eigen-PE (m={SAN_FREQS}) for {len(graphs)} ZINC-shaped "
          f"graphs of {min(sizes)}-{max(sizes)} nodes: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return graphs


def san_serve_slice(graphs, device, card, profile=False):
    """Phase 6: SAN_NodeSpectra served through Predictor on CUDA, one
    request of 128 graphs at a time."""
    model = SANNodeSpectra(**SAN_CFG, seed=0, device=device)
    calibrate_batch_norm(model, collate_graphs(
        graphs[:SAN_GRAPHS], max_nodes=SAN_NODES), device)
    cpu_model = copy.deepcopy(model).to("cpu")
    kw = dict(collate_kwargs={"max_nodes": SAN_NODES}, max_batch=SAN_GRAPHS)
    pred = Predictor(model, device=device, **kw)
    requests = [graphs[i * SAN_GRAPHS:(i + 1) * SAN_GRAPHS]
                for i in range(SAN_REQUESTS)]

    reset_launches()
    outs, call_ms = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(pred.predict(req))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    if launches != {**NONE, "fused_mlp_fwd": 2 * len(requests)}:
        raise AssertionError(f"launch counts {launches} for {len(requests)} "
                             "SAN requests; expected 2 fused_mlp_fwd each")
    for out in outs:
        if out.shape != (SAN_GRAPHS, 1) or not np.isfinite(out).all():
            raise AssertionError(f"bad SAN outputs {out.shape}")
    n_ref = 8
    ref = Predictor(cpu_model, device="cpu", **kw).predict(requests[0][:n_ref])
    err = float(np.abs(outs[0][:n_ref] - ref).max())
    np.testing.assert_allclose(outs[0][:n_ref], ref, **SLICE_TOL)
    steady = statistics.median(call_ms[1:])
    print(f"san serve: {len(requests)} requests of {SAN_GRAPHS} graphs at "
          f"N={SAN_NODES}; ms/call {[round(t, 2) for t in call_ms]}; steady "
          f"(median of the last {len(requests) - 1}) {steady:.2f} ms/call = "
          f"{SAN_GRAPHS / steady * 1e3:.1f} graphs/s on {card}", flush=True)
    print(f"san serve: launches {launches}; CUDA vs CPU outputs of {n_ref} "
          f"graphs: max abs err {err:.3e}, max |y| "
          f"{float(np.abs(ref).max()):.3f} (tolerance rtol 1e-3 atol 1e-3)",
          flush=True)
    if profile:
        profile_call(f"one SAN request of {SAN_GRAPHS} graphs",
                     lambda: pred.predict(requests[0]))
    return launches


def san_train_slice(graphs, device, card, profile=False):
    """Phase 7: SAN_NodeSpectra trained through Trainer (graph_reg, L1)
    on CUDA, FreqTransformer dropout 0.1, eigvec sign flip on; then one
    step on 16 graphs with that dropout at 0, on CUDA and on the CPU."""
    model = SANNodeSpectra(**SAN_CFG, seed=1, device=device)
    initial = copy.deepcopy(model)
    batches = [collate_graphs(graphs[i:i + SAN_GRAPHS],
                              max_nodes=SAN_NODES).to(device)
               for i in (0, SAN_GRAPHS)]
    steps = SAN_TRAIN_EPOCHS * len(batches)
    # the reference ZINC config: lr 7e-4, weight decay 0; warmed up over
    # the first steps, as random weights need (see train_slice)
    trainer = Trainer(model, TrainConfig(task="graph_reg", lr=7e-4,
                                         weight_decay=0.0, sign_flip=True,
                                         seed=0, schedule="warmup",
                                         warmup_steps=steps))
    reset_launches()
    losses, first = timed_epochs(trainer, batches, SAN_TRAIN_EPOCHS)
    more, window = timed_epochs(trainer, batches, SAN_TIMED_EPOCHS)
    launches = read_launches()
    metric = trainer.evaluate(batches)
    syncs = step_syncs(trainer, batches[0])
    total = steps + SAN_TIMED_EPOCHS * len(batches)
    per_step = [r[0] / len(batches) for r in window]
    mean = sum(r[0] for r in window) / (SAN_TIMED_EPOCHS * len(batches))
    print(f"san train: {steps} AdamW steps of {SAN_GRAPHS} graphs at "
          f"N={SAN_NODES} (L1 loss; warmup towards lr 7e-4, weight decay 0, "
          f"FreqTransformer dropout 0.1, eigvec sign flip on); epoch losses "
          f"{[round(x, 6) for x in losses]}; ms/epoch "
          f"{[round(r[0], 2) for r in first]}", flush=True)
    print(f"san train: timed window of {SAN_TIMED_EPOCHS} more epochs = "
          f"{SAN_TIMED_EPOCHS * len(batches)} steps: {mean:.2f} ms/step over "
          f"the window; per epoch ms/step median "
          f"{statistics.median(per_step):.2f}, min {min(per_step):.2f}, max "
          f"{max(per_step):.2f}, stdev {statistics.stdev(per_step):.2f}; "
          f"process CPU ms/epoch {[round(r[2], 2) for r in window]}; new "
          f"device memory segments {sum(r[4] for r in window)}; epoch "
          f"losses {[round(x, 6) for x in more]}; on {card}", flush=True)
    print(f"san train: mae {metric['mae']:.4f} on the training graphs after "
          f"{total} steps; launches {launches}; host syncs in one step (sync "
          f"debug mode): {len(syncs)} {syncs[:3]}", flush=True)
    dropout_cost(device)
    if profile:
        profile_call(f"one SAN training step of {SAN_GRAPHS} graphs",
                     lambda: trainer.step(batches[0]))
    want = {name: total * k for name, k in SAN_STEP_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"launch counts {launches} for {total} SAN "
                             f"steps; expected {SAN_STEP_LAUNCHES} per step")
    if not all(np.isfinite(losses + more)):
        raise AssertionError(f"SAN epoch losses {losses + more}: not finite")
    if syncs:
        raise AssertionError(f"a SAN training step syncs the host: {syncs}")
    initial.pe_transformer.freq_transformer.dropout = 0.0
    step_parity(initial, graphs[:16], device, "san train",
                dict(max_nodes=SAN_NODES),
                TrainConfig(task="graph_reg", sign_flip=False),
                SAN_STEP_PARAMS)
    return launches


def as_float64(batch):
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).double()
        for f in dataclasses.fields(batch)
        if torch.is_tensor(getattr(batch, f.name))
        and getattr(batch, f.name).is_floating_point()})


def step_parity(initial, graphs, device, label, collate, cfg, params):
    """One step from the same weights (sign flip off, so no random numbers
    enter) on CUDA in float32, on the CPU in float32 and on the CPU in
    float64: the loss and the gradients of a few named parameters. The
    float64 step is the reference: from random weights the 10-layer
    network's gradients reach |g| ~ 40 and amplify f32 rounding, so each
    float32 route is held to it, not to the other."""
    batch = collate_graphs(graphs, **collate)
    runs = {"cuda": (copy.deepcopy(initial), batch.to(device)),
            "cpu32": (copy.deepcopy(initial).to("cpu"), batch),
            "cpu64": (copy.deepcopy(initial).to("cpu", torch.float64),
                      as_float64(batch))}
    loss, grads, secs = {}, {}, {}
    for route, (model, b) in runs.items():
        t0 = time.perf_counter()
        loss[route] = float(Trainer(model, cfg).step(b))
        secs[route] = time.perf_counter() - t0
        grads[route] = {name: model.get_parameter(name).grad.double().cpu()
                        for name in params}
    report, bad = [], []
    for name in params:
        ref = grads["cpu64"][name]
        scale = float(ref.abs().max())
        rel = {r: float((grads[r][name] - ref).abs().max()) / scale
               for r in ("cuda", "cpu32")}
        report.append(f"{name} (max |g| {scale:.3e}): cuda {rel['cuda']:.2e}"
                      f", cpu32 {rel['cpu32']:.2e}")
        if not torch.isfinite(grads["cuda"][name]).all() or \
                rel["cuda"] > STEP_GRAD_REL:
            bad.append(name)
    print(f"{label}: one step on {len(graphs)} graphs from the initial weights;"
          f" loss cuda {loss['cuda']:.8f}, cpu32 {loss['cpu32']:.8f}, cpu64 "
          f"{loss['cpu64']:.8f}; grad max abs err / max |g| against cpu64: "
          + "; ".join(report) + f" (tolerance for cuda: loss rtol "
          f"{STEP_LOSS_RTOL}, grads {STEP_GRAD_REL}; CPU steps "
          f"{secs['cpu32']:.1f} s f32, {secs['cpu64']:.1f} s f64)",
          flush=True)
    if abs(loss["cuda"] - loss["cpu64"]) > STEP_LOSS_RTOL * abs(loss["cpu64"]):
        raise AssertionError(f"step loss CUDA {loss['cuda']} vs float64 "
                             f"{loss['cpu64']}")
    if bad:
        raise AssertionError(f"CUDA gradients off the float64 step: {bad}")


def profile_call(label, fn):
    """Device time by kernel over one call (torch.profiler), and the
    device's busy share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = lambda e: e.self_device_time_total / 1e3
    rows = sorted((e for e in events               # kernels and copies; an
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)),
                  key=dev, reverse=True)           # annotation spans them
    busy = sum(dev(e) for e in rows)
    host = lambda e: e.self_cpu_time_total / 1e3
    ops = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU),
                 key=host, reverse=True)
    print(f"profile: {label}, wall {wall_ms:.2f} ms, device busy "
          f"{busy:.2f} ms ({100 * busy / wall_ms:.1f} %) in "
          f"{sum(e.count for e in rows)} device events; host self time "
          f"{sum(host(e) for e in ops):.2f} ms in "
          f"{sum(e.count for e in ops)} host events", flush=True)
    for e in rows[:15]:
        print(f"profile:   {dev(e):9.3f} ms  x{e.count:<4d} {e.key[:90]}")
    for e in ops[:8]:
        print(f"profile:   host {host(e):9.3f} ms  x{e.count:<5d} "
              f"{e.key[:80]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA card", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {card}",
          flush=True)

    t0 = time.perf_counter()
    build.build_all()
    print(f"built {', '.join(build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rows = check_kernels(device)
    rows.update(check_bwd_kernels(device))
    rows.update(check_fused_mlp(device))
    profile = "--profile" in sys.argv
    graphs = make_graphs()
    runs = [serve_slice(graphs, device, card, profile=profile),
            train_slice(graphs, device, card, profile=profile)]
    san_graphs = make_san_graphs()
    runs += [san_serve_slice(san_graphs, device, card, profile=profile),
             san_train_slice(san_graphs, device, card, profile=profile)]

    pallas = "feta_tmlr_tpu/ops/pallas/"
    meta = {"flash_fwd": ("flash_fwd.cu", "flash_attention.py:95"),
            "colstat": ("colstat.cu", "flash_attention.py:776"),
            "flash_bwd_q": ("flash_bwd.cu", "flash_attention.py:528"),
            "flash_bwd_k": ("flash_bwd.cu", "flash_attention.py:556"),
            "fused_mlp_fwd": ("fused_mlp.cu", "fused_mlp.py:58"),
            "fused_mlp_bwd": ("fused_mlp.cu", "fused_mlp.py:70")}
    # launches: the main paths' runs (SBM and SAN, serving and training)
    kernels = [dict(name=name, route="cuda",
                    source=f"feta_tmlr_tpu_torch/csrc/{src}",
                    replaces=pallas + line,
                    launches=sum(run[name] for run in runs),
                    max_abs_err=rows[name]["max_abs_err"],
                    ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"],
                    bound_ms=rows[name]["bound_ms"],
                    bound_by=rows[name]["bound_by"], library_ms=None)
               for name, (src, line) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
