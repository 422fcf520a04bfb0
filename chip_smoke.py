#!/usr/bin/env python3
"""Drive the PyTorch port of FeTA on one NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. environment: torch version, the card's name and power limit; TF32 off
     for matmuls and cuDNN, so every float32 product is full float32;
  2. build the CUDA kernels from `feta_tmlr_tpu_torch/csrc/` (one nvcc per
     source, all started together) and print the build seconds;
  3. hold each kernel against its plain PyTorch version on the card, at the
     slice's shapes (B=8, H=8, N=1024, D=64, value widths 64 and 8) and at a
     ragged N=200, with padded nodes; print the largest absolute error, the
     kernel's and the plain version's median milliseconds (CUDA events);
  4. serve the FeTA SBM node classifier (DiffGraphTransformerGenGCNSBM at
     d_model 64, 8 heads, 10 layers, ff 128, batch norm, LapPE 8, Chebyshev
     order 4; random weights from a seed) at N=1024 through `Predictor` on
     CUDA: four requests (8, 8, 8 and 5 graphs), launch counts read around
     them, logits of two graphs held against the CPU path;
  5. print the kernels' JSON line, the card line, and the final status line
     `{"ok": true, "device": {...}}`.

`--profile` adds a torch.profiler breakdown of one request's device time.
It needs one card and exits non-zero without printing a result when CUDA
is unavailable.
"""

from __future__ import annotations

import copy
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from feta_tmlr_tpu_torch.data.batch import collate_graphs
from feta_tmlr_tpu_torch.data.synthetic import sbm_like_dataset
from feta_tmlr_tpu_torch.nn.layers import MaskedBatchNorm
from feta_tmlr_tpu_torch.nn.models import DiffGraphTransformerGenGCNSBM
from feta_tmlr_tpu_torch.ops.kernels import build
from feta_tmlr_tpu_torch.ops.kernels import colstat as cs_mod
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as fl_mod
from feta_tmlr_tpu_torch.pe.encodings import DiffusionEncoding, LapEncoding
from feta_tmlr_tpu_torch.serve import Predictor

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES = 3.35e12            # HBM3
KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)   # f32, sums in another order
SLICE_TOL = dict(rtol=1e-3, atol=1e-3)    # 10 f32 layers, CUDA vs CPU
MODEL_CFG = dict(in_size=3, nb_class=2, d_model=64, nb_heads=8,
                 dim_feedforward=128, dropout=0.0, nb_layers=10,
                 batch_norm=True, lap_pos_enc=True, lap_pos_enc_dim=8,
                 filter_order=4)
N_NODES = 1024
N_GRAPHS = 8


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


def check_kernels(device, b=8, h=8, d=64, sizes=((N_NODES, 60), (200, 9))):
    """Phase 3: each kernel vs its plain version; returns the JSON rows
    (numbers of the main path's dominant shape, errors over all shapes)."""
    rows = {}
    errs = {"flash_fwd": 0.0, "colstat": 0.0}
    for n, pad in sizes:
        for dv in (64, 8):
            ops, vw = attention_inputs(n + dv, b, h, n, d, dv, pad, device)
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
            if n == sizes[0][0] and dv == 64:
                rows["flash_fwd"] = dict(ms=t_k, plain_ms=t_p, bound_ms=fb,
                                         bound_by=fby)
                rows["colstat"] = dict(ms=c_k, plain_ms=c_p, bound_ms=cb,
                                       bound_by=cby)
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


def calibrate_batch_norm(model, graphs, device):
    """Non-trivial running statistics, as training leaves them: one
    train-mode pass with momentum 0 sets every MaskedBatchNorm's running
    mean and variance to the masked statistics of its input on `graphs`
    (random statistics instead would let activations grow layer by layer
    to magnitudes no trained model has)."""
    norms = [m for m in model.modules() if isinstance(m, MaskedBatchNorm)]
    batch = collate_graphs(graphs, max_nodes=N_NODES, node_labels=True)
    for m in norms:
        m.momentum = 0.0
    model.train()
    with torch.no_grad():
        model(batch.to(device))
    model.eval()
    for m in norms:
        m.momentum = 0.9


def serve_slice(device, card, profile=False):
    """Phase 4: the port's main path through Predictor on CUDA."""
    graphs = make_graphs()
    model = DiffGraphTransformerGenGCNSBM(**MODEL_CFG, seed=0, device=device)
    calibrate_batch_norm(model, graphs, device)
    cpu_model = copy.deepcopy(model).to("cpu")
    kw = dict(collate_kwargs={"max_nodes": N_NODES, "node_labels": True},
              node_level=True)
    pred = Predictor(model, device=device, max_batch=N_GRAPHS, **kw)
    requests = [graphs, graphs[3:] + graphs[:3], graphs[::-1], graphs[:5]]

    fl_mod.flash_fwd.launches = 0
    cs_mod.colstat.launches = 0
    outs, call_ms = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(pred.predict(req))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"flash_fwd": fl_mod.flash_fwd.launches,
                "colstat": cs_mod.colstat.launches}
    forwards = len(requests)
    if launches != {"flash_fwd": 10 * forwards, "colstat": 2 * forwards}:
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
        profile_predict(pred, graphs)
    return launches


def profile_predict(pred, graphs):
    """Device time by kernel over one 8-graph request (torch.profiler), and
    the device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile
    pred.predict(graphs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(graphs)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = lambda e: e.self_device_time_total / 1e3
    rows = sorted((e for e in prof.key_averages()           # device events
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=dev, reverse=True)
    busy = sum(dev(e) for e in rows)
    print(f"profile: one request of {len(graphs)} graphs, wall "
          f"{wall_ms:.2f} ms, device busy {busy:.2f} ms "
          f"({100 * busy / wall_ms:.1f} %)", flush=True)
    for e in rows[:15]:
        print(f"profile:   {dev(e):9.3f} ms  x{e.count:<4d} {e.key[:90]}")


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
    launches = serve_slice(device, card, profile="--profile" in sys.argv)

    meta = {
        "flash_fwd": dict(
            source="feta_tmlr_tpu_torch/csrc/flash_fwd.cu",
            replaces="feta_tmlr_tpu/ops/pallas/flash_attention.py:95"),
        "colstat": dict(
            source="feta_tmlr_tpu_torch/csrc/colstat.cu",
            replaces="feta_tmlr_tpu/ops/pallas/flash_attention.py:776"),
    }
    kernels = [dict(name=name, route="cuda", source=meta[name]["source"],
                    replaces=meta[name]["replaces"],
                    launches=launches[name],
                    max_abs_err=rows[name]["max_abs_err"],
                    ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"],
                    bound_ms=rows[name]["bound_ms"],
                    bound_by=rows[name]["bound_by"], library_ms=None)
               for name in ("flash_fwd", "colstat")]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
