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
     the plain version's median device milliseconds (CUDA events, each call
     queued behind ~1 ms of device spin; see `time_ms`) and the bound,
     counted from the mask (the attention kernels' from the pairs whose
     query and key are both real: `real_counts`; the
     four backward passes, which run on the tensor cores in 3xTF32, also
     against that arithmetic's bound, and the folded ones against the
     unfolded):
     the attention kernels at H=8, N=1024, D=64, value widths 64 and 8
     (B=4, the training batch, and B=8, the serving batch) and at a ragged
     N=200 with B=8 and at the ZINC batch (B=128, N=48), with padded
     nodes, the backward kernels also on rows in the |su/se| <= 1e-9
     branch; the unfolded ones again at the molhiv width D=128, value
     widths 128 and 16, at B=4, N=1024 and at the molhiv request's
     B=128, N=222 (20-27 real nodes a graph), each
     output also within 2x the CPU float32 route's error from a float64
     run of the plain version; the head-folded attention kernels at B=1
     and B=2, N=2048 and at B=2, N=1990, value widths 64 and 8, against
     their plain versions and their unfolded CUDA twins, guard rows
     included, two runs bit-identical; the fused-MLP kernels at the SAN
     eigen-PE head's 40,960
     rows (d 8, F 2048) and at a ragged 10,007, at dropout 0 and 0.1, at
     the PATTERN head's 30,080 rows at d 16 (two forward slabs) at both
     rates and at the SAN_EdgeLPE pair head's 462,080 rows at d 8 at
     0.1, each timed warm and cold, with
     their masks read back bit-equal to the plain version's, a keep
     fraction of 0.9 +- 0.002, two forward and two backward runs
     bit-identical and each output within 2x the CPU float32 route's
     error from a float64 run of the plain version, at both rates; the
     modulation kernels at B=128, N=48, at B=32, N=128, at B=4, N=1024 and
     at B=2 and B=1, N=2048 (each also timed with the L2 cache overwritten
     before every call, `time_ms(cold=True)`, beside a bound counted from
     the mask: `modulation_cost`), their outputs exactly 0 at every cell with
     a masked query or key, and the fused attention kernels at the first
     two, with padded nodes and rows in the |denom| <= 1e-9 branch, two
     backward runs bit-identical, each output within 2x the CPU float32
     route's error from a float64 run of the plain version (the modulation
     kernels at the ZINC batch and at B=1, N=2048); then the flash forward
     and both backward passes and the fused pair at the ZINC batch with pe
     and deg absent (nullptr, the vanilla GraphTransformer's attention),
     against their plain versions, two runs of each bit-identical
     (`check_unmodulated`);
  4. serve the FeTA SBM node classifier (DiffGraphTransformerGenGCNSBM at
     d_model 64, 8 heads, 10 layers, ff 128, batch norm, LapPE 8, Chebyshev
     order 4; random weights from a seed) at N=1024 through `Predictor` on
     CUDA: four requests (8, 8, 8 and 5 graphs), launch counts read around
     them, logits of two graphs held against the CPU path in float64 (the
     CPU's float32 route printed beside); each LapPE eigenvector's sign is
     fixed (`canonical_signs`), so every host serves the same inputs;
  5. train the same model on the same 8 graphs through `Trainer` on CUDA:
     2 batches of 4 graphs, 3 epochs of AdamW (6 steps, warmup towards lr
     1e-3) with finite and falling loss, then a timed window of 10 more
     epochs (20 steps: ms per step over the window with its spread, and
     each epoch's process CPU time, garbage-collection time and new device
     memory segments); launch counts per step over all 26 steps; acc_sbm;
     no host sync in one more step (torch's sync debug mode);
     then one step from the same initial weights on CUDA,
     on the CPU in float32 and on the CPU in float64, the CUDA loss and
     gradients held to the float64 ones (loss rtol 5e-5, see
     SBM_STEP_LOSS_RTOL);
  6. serve SAN_NodeSpectra (ZINC: hidden 56, 8 heads, 10 layers, eigen-PE
     head of dim 8, 4 heads, 2 layers, ff 2048 over m=10 frequencies,
     typed bond edges, batch norm, Chebyshev order 4 in every layer) through
     `Predictor`: four requests of 128 ZINC-shaped graphs padded to 32
     nodes, 2 fused-MLP forward launches each, 8 graphs held against the
     CPU path;
  7. train it through `Trainer` (graph_reg, L1): 2 batches of 128 graphs,
     3 epochs warming up towards lr 7e-4 (weight decay 0, FreqTransformer
     dropout 0.1, eigvec sign flip on), then a timed window of 5 epochs;
     2 + 2 fused-MLP launches per step, finite loss, no host sync in a
     step (torch's sync debug mode); the eigen-PE dropout mask's device
     and host time and kernel count; then one step on 16 graphs with that
     dropout at 0, CUDA against the CPU in float64;
  8. serve the flagship ZINC regressor (DiffGraphTransformerGenGCN at
     bench.py's widths: in_size 28, d_model 64, 8 heads, 10 layers, ff 128,
     batch norm, LapPE 8, Chebyshev order 4) through `Predictor` on its
     three attention routes: "fused" (the fused attention kernels on the
     nine unfiltered layers, the modulation kernel on the filtered one),
     four requests of 128 zinc_like_dataset graphs padded to 48 nodes, 9 +
     1 launches each, 8 graphs held against the CPU path; "modulation" and
     "flash", two requests each;
  9. train it through `Trainer` (graph_reg, L1; AdamW lr 1e-3, sign flip
     on) on 2 batches of 128 graphs: "fused" for 3 + 10 timed epochs, with
     exact launch counts per step, finite loss, no host sync in a step, and
     one step on 16 graphs on CUDA against the CPU in float64; "modulation"
     and "flash" for 1 + 4 epochs; the three routes' ms/request and ms/step
     side by side, then in 5 interleaved rounds (one request and one epoch
     of each route per round, the order rotating) with their medians and
     quartiles;
 10. the SBM model at N=2048 (examples/largen_combo_ab.py's step), its
     depth cut to 5 layers (LARGE_LAYERS), under the
     three settings of the attention dispatch: "fold" (head_fold, the
     head-folded kernels on every layer) serves two requests of 2 graphs
     (5 + 2 launches each, one graph's logits held to the CPU in float64)
     and trains on 4 one-graph batches for 2 + 5 timed epochs (5 + 2 + 5
     + 5 launches a step, falling loss, no host sync, one step held to a
     float64 CPU step; both held at the N=1024 tolerances or within a
     stated multiple of the CPU's float32 error on the same input, see
     LOGITS_CPU32_FACTOR); "stream" (the unfolded kernels) and "r4"
     (flash_need_heads off: the filtered layer through the score product
     and the modulation kernel) serve two requests and train 1 + 2 epochs;
     then 3 interleaved rounds of one request and one epoch per setting;
 11. the OGB molhiv classifier (DiffGraphTransformerGenGCNMolHiv at its
     CLI's widths: d_model 128, 8 heads, 4 layers, ff 256, Chebyshev
     order 4, no batch norm, no PE; random weights from a seed) on the
     "flash" route: three requests of 128 ogb_like_dataset molecules
     through `Predictor` padded to their own largest molecule and three
     padded to N=222 (ogbg-molhiv's largest), 4 + 2 launches each, the
     logits held to a float64 CPU forward (all 128 at their own padding,
     every 16th at N=222), ms per request and graphs/s; the 10 molecules of tests/fixtures/ogbg_molhiv
     read by `data/ogb_raw.py` and served at N=222; 3 binary_graph steps
     (sigmoid BCE, warmup) on the 128 molecules, 4 + 2 + 4 + 4 launches a
     step, then one step on 16 graphs held to a float64 CPU step;
 12. lpe: the LPE codebase's other nets, each built by its config trainer
     at its config's widths with random weights from a seed: SAN_NodeLPE
     (configs/LPE/ZINC/optimized.json as written: 10 layers of width 56,
     eigen-PE dim 8 over 2 layers; 32 ZINC-shaped graphs padded to N=38),
     the PATTERN SAN_NodeLPE (configs/LPE/PATTERN/optimized.json: 4
     layers of width 80, 10 heads, eigen-PE dim 16 over 3 layers, per-node
     readout; 16 synthetic SBMs of 165-188 nodes padded to N=188, so the
     fused MLP at width 16 over 30,080 rows, two slabs), SAN_EdgeLPE (ZINC
     optimized.json's widths with "LPE": "edge": the pair eigen-PE over
     B*N*N*m = 462,080 rows) and GATFeTA
     (configs/LPE/ZINC_GATFeTA_optimized.json: 16 layers, 8 heads of 22;
     128 graphs): 3 requests through Predictor each (exact fused_mlp_fwd
     launches, the first 4 graphs held to a float64 CPU forward), 10
     training steps (warmup, exact fused-MLP launches, finite loss, no
     host sync), one step on 4 graphs held to a float64 CPU step; ms per
     request and per step;
 13. lspe: the LSPE codebase's nets (none runs a TPU kernel: every launch
     counter must read 0), each built by its config trainer at its
     config's widths and depths with random weights from a seed:
     GraphiT-Spectra-LSPE (configs/LSPE/GraphiT_ZINC_LSPE.json with
     --model GraphiTSpectra: 10 layers of width 48, 8 heads, RWPE 16, the
     adaptive edge kernel of 16 steps at gamma 0.25; 32 ZINC-shaped
     graphs padded to N=38), the PATTERN Spectra net
     (GraphiT_SBM_PATTERN_LSPE.json, per-node readout; 16 synthetic SBMs
     padded to N=188), SAN-LSPE (SAN_ZINC_LSPE.json, learned gamma; 32
     graphs), GatedGCN-LSPE (GatedGCN_ZINC_LSPE.json: 16 layers of width
     59; 128 graphs) dense and on COO batches, PNA-LSPE (PNA_ZINC_LSPE.json:
     16 layers of width 55, 5 stacked towers, bond features of width 40;
     128 graphs) dense and sparse: 3 requests through Predictor each (the
     first 4 graphs held to a float64 CPU forward), 10 training steps
     (warmup, finite loss), one step on 4 graphs held to a float64 CPU
     step (the PATTERN nets, here and in the lpe phase, with every
     parameter's error ranked against the CPU float32 route's; the lpe
     phase's again with the fused MLP's plain versions on the card), the COO
     runs' logits and card step held to their dense twins; ms per request
     and per step;
 14. graphit: the GraphiT baselines and the FeTA filter's options, random
     weights from a seed: DiffGraphTransformer and the vanilla
     GraphTransformer (no attention PE) at bench.py's ZINC widths (in 28,
     d_model 64, 8 heads, 10 layers, ff 128, batch norm, LapPE 8,
     diffusion PE) on "flash" (#1, #3, #4) and on "fused" (#10, #11),
     DiffGraphTransformerGenGCN at the same widths with the ARMA filter,
     with the filter in every layer (#1 and #2 in each) and with `remat`,
     on 2 batches of 128 zinc_like_dataset graphs padded to 48, and
     DiffGraphTransformerMolHiv at d_model 128 (8 heads, 4 layers, ff 256)
     on 128 ogb_like_dataset molecules on "flash": each 3 requests through
     Predictor (the first 8 graphs' logits held to a float64 CPU forward)
     and 10 steps through Trainer (finite losses, no host sync), exact
     launches a request and a step, one step on 16 graphs held to a
     float64 CPU step; ms per request and per step; the `remat` step
     bit-equal to the same step without it, with one more forward's
     launches; the molhiv baseline refusing "fused" and `head_fold` at
     d_model 128 (`graphit_slice`, ~30 s);
 15. packed: the same FeTA ZINC model at bench.py's widths on 128
     zinc_like_dataset graphs packed into ~24 rows of 128 nodes
     (data/pack.py, PackedDiffGraphTransformerGenGCN: every layer on the
     plain pair-masked attention, no kernel) against the same graphs
     padded to 48 on "flash", the same weights: 3 eval requests and 10
     Trainer steps each, ms a request and a step side by side; no launch
     on the packed path (exact on the padded one), no host sync in a
     packed step; the packed logits, mapped back to the graphs, held to
     the padded ones on the card within 1e-4 and to a float64 CPU forward
     (the CPU float32 route's error beside); one packed step on 32 graphs
     held to a float64 CPU step (`packed_slice`);
 16. cli: the port's command-line entry points, as a user runs them (each
     module's main() with its argv, in this process so the launch counters
     see it): the config-driven trainer
     (experiments/main_ZINC_graph_regression.py) trains SAN_NodeSpectra at
     configs/LPE/ZINC/optimized.json's widths (hidden 56, 10 layers, 8
     heads, eigen-PE dim 8 with 4 heads and 2 layers, sum readout) on the
     ZINC fixture (tests/fixtures/molecules) for 2 epochs into a
     checkpoint directory, then one epoch more with --resume; serve_main
     starts from that checkpoint in the background with --warmup and
     answers 8 POST /predict requests of 32 raw ZINC-shaped graphs on
     127.0.0.1 (eigen-PE computed server-side), each answer held to an
     in-process Predictor restored from the same checkpoint within 1e-5,
     2 fused_mlp_fwd launches a request, ms per request; the 256 graphs
     as one request of 16 chunks through the Predictor's window bit-equal
     to one chunk a call; feta-zinc
     (run_transformer_gengcn.py) at bench.py's widths with --lappe
     --lap-dim 8 --pos-enc diffusion on the ZINC fixture and feta-molhiv
     at d_model 128 on its synthetic fallback, feta-sbm on the SBM fixture
     (tests/fixtures/SBMs) and feta-tu-cv on the TU fixture
     (tests/fixtures/TUFIX) at their CLIs' defaults with --lappe, 2
     epochs and one resumed epoch each; logs.csv's columns as the JAX CLIs
     write them, finite losses, and each run's kernels launched (#12/#13
     for the config trainer, #1-#4 for the FeTA CLIs) and no other; then
     the LPE configs as written, with no --model: the ZINC trainer on
     optimized.json (SAN_NodeLPE) with a resumed epoch, then serve_main
     from its checkpoint, and on optimized_gat_1.json (GAT, no kernel),
     the SBM trainer on configs/LPE/CLUSTER/optimized.json (sparse
     SAN_NodeSpectra, 16 layers, eigen-PE dim 16) on synthetic SBMs, and
     the molhiv trainer on
     configs/LPE/MOLHIV/optimized_spectral_full_1.json on the fixture's
     molecules (layer dropout 0.01, sum readout, eigen-PE dim 16); then
     the LSPE configs as written: the ZINC trainer on
     GatedGCN_ZINC_LSPE_withLapEigLoss.json (the lapeig term added to the
     loss), the SBM trainer on GraphiT_SBM_PATTERN_LSPE.json (synthetic
     SBMs) and the OGBMOL trainer on GatedGCN_MOLPCBA_LSPE.json (the
     ogbg-molpcba fixture), each 2 epochs and a resume to 4 held bit for
     bit to 4 epochs in one run, no kernel launched; the ZINC trainer's
     GraphiT-Spectra-LSPE (GraphiT_ZINC_LSPE.json, --model
     GraphiTSpectra) with a resumed epoch, served by serve_main from its
     checkpoint (random-walk PE and edge kernel server-side), each answer
     held to the in-process Predictor within 1e-5; then the GraphiT
     baseline CLIs (run_transformer.py with and without --vanilla,
     run_transformer_gcn.py on the ZINC fixture, run_transformer_cv.py and
     run_transformer_gcn_cv.py on TUFIX, run_transformer_SBM_cv.py on the
     SBM fixture, run_transformer_molhiv.py on its synthetic fallback),
     feta-zinc with --gnn_type ARMAConvDynamic and with --last_layer_filter,
     and the TU config trainer (main_TU_graph_classification.py) on TUFIX
     with configs/LPE/ZINC/optimized.json (SAN_NodeLPE: #12/#13) and with
     configs/LSPE/GraphiT_ZINC_LSPE.json --model GraphiT (no kernel), 2
     epochs and one resumed each (`CLI_GRAPHIT_RUNS`); then feta-zinc
     --packed on the ZINC fixture (no launch), feta-molpcba at d_model 128
     on 640 synthetic molecules (batches of 256, 128 tasks) and
     feta-pcqm4m on the LSC fixture through data/smiles.py, each 2 epochs
     and a resume to 4 held bit for bit to 4 epochs in one run, #1-#4
     launched exactly as counted (`CLI_OGB_RUNS`, `cli_flash_launches`);
     then feta-zinc-gckn at its defaults on the ZINC fixture (2 epochs
     and a resume to 4 held bit for bit to 4 in one run, the GCKN codes
     recomputed in every run, #1-#4 exact), the nine other GCKN CLIs once
     each (`CLI_GCKN_RUNS`, k-means over 10,000 sampled paths), and the
     GAT config (configs/LPE/ZINC/optimized_gat_1.json, batches of 128) on
     320 synthetic molecules, 2 epochs and a resume to 4 held bit for bit
     (`CLI_GAT_B128`: the one-hot table gradients of nn/lookup.py);
 17. gckn (run before the cli phase): 128 zinc_like_dataset graphs at
     feta-zinc-gckn's GCKN settings (paths of up to 8 nodes, 32 anchors,
     sigma 0.6, sum pooling, k-means over 100,000 sampled paths): the
     native enumeration and path batch and the numpy k-means timed on the
     host, the encode on the card timed with its peak device memory, two
     encodes bit-equal, held to a float64 encode on the card and (16
     graphs) to the CPU's float32 encode within 1e-4 of the largest code;
     the standardised codes as the lap-PE input of the ZINC regressor
     (d_model 64, 8 heads, 10 layers, lap_pos_enc_dim 32) on "flash": one
     request of the 128 graphs (10 + 2 launches, 8 graphs' logits held to
     a float64 CPU forward), 5 steps (exact launches) and one step on 16
     graphs held to a float64 CPU step; GCKNSupervised at gckn_sup.py's
     defaults (paths of 4 nodes, hidden 32, sigma 0.5, sum pooling) on 76
     graphs: 5 Adam steps, no launch, its first step (two runs bit-equal)
     held to float64 on the card (`gckn_slice`);
 18. bf16 (run before the cli phase): the bf16 compute policy
     (FETA_COMPUTE_DTYPE=bfloat16, `bf16_slice`): the unfolded flash forward,
     colstat and both backward passes with bf16 operands at the SBM training
     batch (B=4, N=1024, H=8) at D=64 (value widths 64 and 8) and D=128 (128
     and 16), and at D=64 at the SBM request (B=8) and the ZINC batch (B=128,
     N=48), pe and deg in bf16 and in float32, each against its plain bf16
     version on the card, two runs bit-identical; on the training and the ZINC
     batch some held to float64 within 2x the CPU plain bf16 route's error; on
     the training batch timed beside the float32 kernel on the same values with
     bounds at the bf16 peak and 2-byte operands (the JSON rows' `*_bf16` and
     `ms_f32_twin`); the SBM and ZINC models at 2 layers under each bf16 route
     (pe/deg bf16 and float32) on the card against the CPU plain version of
     that route, logits and gradients within 2x the CPU routes' spread, the
     route by its entry points (`bf16_route_check`); the SBM model of phase 4
     served (4 requests of 8 graphs) and trained (4 epochs of 2 steps, the
     first a warm-up) under bf16 and float32 in turns on the same weights,
     every launch counted by wrapper and by C entry point
     (`entry_point_tally`), graph 0's served logits held to a float64 CPU
     forward within 3x the CPU bf16 route's error; the ZINC regressor of phase
     8 on "flash" and "modulation" under both policies (`zinc_serve`,
     `zinc_train`), their requests and epochs in 3 interleaved rounds, one bf16
     step on 16 graphs held to a float64 CPU step as the logits are;
     feta-torch-zinc under bf16, 2 + 2 epochs bit for bit against 4, every
     flash launch through a bf16 entry point. Then the fused
     pair #10/#11 in bf16 at the ZINC batch and at B=32, N=128, and the
     fused MLP pair #12/#13 in bf16 at 40,960 rows (d 8, rates 0 and 0.1),
     30,080 (d 16) and the pair head's 462,080 (`check_bf16_fused`,
     `check_bf16_mlp`): each against its plain bf16 version, two runs
     bit-identical, timed beside the float32 kernel on the same values
     with the bf16 bound; the ZINC regressor on "fused", SANNodeSpectra at
     the san phase's widths and the lpe phase's four nets, each served
     and trained under bf16 and float32 in turns on the same weights,
     launches counted by wrapper and by entry point, 2 graphs' logits
     and one step held to float64 within 3x the CPU bf16 route's error
     (`bf16_policy_net`); the route check at 2 layers for "fused" and
     SANNodeSpectra; the LPE config trainer (SAN_NodeLPE) under bf16, 2 +
     2 epochs bit for bit against 4, every MLP launch through `_bf16`;
 19. print the kernels' JSON line, the card line, and the final status line
     `{"ok": true, "device": {...}}`.

`--profile` adds torch.profiler breakdowns of one request's and one
training step's device time, for each model (ZINC on the "fused" route,
SBM at N=2048 under "fold", molhiv requests at both paddings).
`--rounding` runs only phase 5's parity step, on the canonical LapPE signs
and on 8 random sign patterns, and prints how far float32 rounding moves
its loss and gradients from float64 on CUDA and on the CPU; then phase
10's parity step and one graph's served logits at N=2048 over 4 random
patterns, with each CUDA error over the CPU float32 route's.
`--precision` runs only a probe of phase 10's forward and backward: each
layer re-run from the float64 forward's inputs in float32 on the CPU, on
the card and on the card with the plain versions (`plain_kernels`), its
steps held to float64, then one graph's logits on each route; then each
part of the `--rounding` parity step's backward (every layer, the
coefficient head, the Chebyshev filter, the output maps) re-run from the
float64 step's inputs and output cotangents on the same routes, each
gradient held to float64, on the canonical LapPE signs and on sign
pattern 4, and that step's gradient error under four summation orders.
It needs one card and exits non-zero without printing a result when CUDA is
unavailable.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import gc
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from feta_tmlr_tpu_torch.data.batch import collate_graphs
from feta_tmlr_tpu_torch.data.pack import pack_graphs, pack_rows
from feta_tmlr_tpu_torch.data.sbm import load_sbm_or_synthetic
from feta_tmlr_tpu_torch.data.ogb_raw import (
    ATOM_FEATURE_DIMS,
    load_ogb_graphs,
)
from feta_tmlr_tpu_torch.data.synthetic import (
    ogb_like_dataset,
    sbm_like_dataset,
    zinc_categorical_dataset,
    zinc_like_dataset,
)
from feta_tmlr_tpu_torch.experiments import (
    main_ZINC_graph_regression as cli_zinc_config,
)
from feta_tmlr_tpu_torch.experiments import run_transformer_gengcn as cli_zinc
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gengcn_cv as cli_tu,
)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gengcn_molhiv as cli_molhiv,
)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gengcn_molpcba as cli_molpcba,
)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gengcn_pcqm4m as cli_pcqm4m,
)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gengcn_SBM_cv as cli_sbm,
)
from feta_tmlr_tpu_torch.experiments import (
    main_molhiv_graph_classification as cli_molhiv_config,
)
from feta_tmlr_tpu_torch.experiments import (
    main_OGBMOL_graph_classification as cli_ogbmol_config,
)
from feta_tmlr_tpu_torch.experiments import (
    main_SBMs_node_classification as cli_sbm_config,
)
from feta_tmlr_tpu_torch.experiments import (
    main_TU_graph_classification as cli_tu_config,
)
from feta_tmlr_tpu_torch.experiments import run_transformer as cli_graphit
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_cv as cli_graphit_cv,
)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gcn as cli_graphit_gcn,
)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gcn_cv as cli_graphit_gcn_cv,
)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_molhiv as cli_graphit_molhiv,
)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_SBM_cv as cli_graphit_sbm,
)
from feta_tmlr_tpu_torch.experiments import serve_main as cli_serve_main
from feta_tmlr_tpu_torch.experiments import gckn_sup as cli_gckn_sup
from feta_tmlr_tpu_torch.experiments import gckn_sup_cv as cli_gckn_sup_cv
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gckn as cli_gckn_graphit)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gckn_cv as cli_gckn_graphit_cv)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gckn_gengcn as cli_zinc_gckn)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gckn_gengcn_cv as cli_gckn_cv)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gckn_gengcn_molpcba as cli_gckn_molpcba)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gckn_gengcn_SBM_cv as cli_gckn_sbm)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gckn_molhiv as cli_gckn_graphit_molhiv)
from feta_tmlr_tpu_torch.experiments import (
    run_transformer_gckn_SBM_cv as cli_gckn_graphit_sbm)
from feta_tmlr_tpu_torch.gckn.layer import sample_paths, unsup_train_layer
from feta_tmlr_tpu_torch.gckn.models import (
    GCKNFeature,
    GCKNSupervised,
    attach_codes,
)
from feta_tmlr_tpu_torch.gckn.paths import build_path_batch
from feta_tmlr_tpu_torch.nn import feta as feta_mod
from feta_tmlr_tpu_torch.nn.layers import MaskedBatchNorm
from feta_tmlr_tpu_torch.nn.models import (
    DiffGraphTransformer,
    DiffGraphTransformerGenGCN,
    DiffGraphTransformerGenGCNSBM,
    DiffGraphTransformerMolHiv,
    GraphTransformer,
)
from feta_tmlr_tpu_torch.nn.ogb import DiffGraphTransformerGenGCNMolHiv
from feta_tmlr_tpu_torch.nn.packed import PackedDiffGraphTransformerGenGCN
from feta_tmlr_tpu_torch.nn.pna import average_log_degree
from feta_tmlr_tpu_torch.nn.san import SANNodeSpectra, hash_dropout
from feta_tmlr_tpu_torch.ops.cheb import node_matmul
from feta_tmlr_tpu_torch.ops.kernels import build
from feta_tmlr_tpu_torch.ops.kernels import colstat as cs_mod
from feta_tmlr_tpu_torch.ops.kernels import flash_attention as fl_mod
from feta_tmlr_tpu_torch.ops.kernels import fused_attention as fa_mod
from feta_tmlr_tpu_torch.ops.kernels import fused_mlp as fm_mod
from feta_tmlr_tpu_torch.ops.kernels import modulation as mod_mod
from feta_tmlr_tpu_torch.ops.kernels.common import bwd_row_constants
from feta_tmlr_tpu_torch.pe.encodings import (
    DiffusionEncoding,
    LapEncoding,
)
from feta_tmlr_tpu_torch.pe.laplace import apply_laplace_decomp
from feta_tmlr_tpu_torch import serve as serve_mod
from feta_tmlr_tpu_torch.serve import Predictor
from feta_tmlr_tpu_torch.serve_http import _graph_from_json
from feta_tmlr_tpu_torch.train.trainer import (
    TrainConfig,
    Trainer,
    task_metric,
)
from feta_tmlr_tpu_torch.utils.config import load_config

# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit)
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BYTES = 3.35e12            # HBM3
L2_BYTES = 50 * 2**20           # the L2 cache that `time_ms(cold=True)` evicts
PEAK_TF32_FLOPS = 495e12        # TF32 on the tensor cores, dense
TF32_SPLIT = 3                  # TF32 products per f32 product (3xTF32)
# 32-bit integer instructions: 64 a clock and SM (the CUDA C++ Programming
# Guide's throughput table, compute capability 9.0) x 132 SMs x 1.98 GHz
# (the clock at which the f32 peak above is 132 x 128 x 2 x 1.98e9), the
# multiplies on the FMA pipe, the others on the INT32 lanes
PEAK_INT32_OPS = 132 * 64 * 1.98e9
# warp instructions dispatched: one a clock per SM sub-partition, four an
# SM, at the same clock
PEAK_WARP_ISSUE = 132 * 4 * 1.98e9
MMA_FLOPS = 2 * 16 * 8 * 8      # one m16n8k8 product (mma.sync, HMMA)
# the dropout keep bit of one (row, unit) (`Dropout::keep_scale`,
# csrc/fused_mlp.cu), counted from the SASS by `kernel_ab.py --mlp
# --check`: its integer multiplies and its other instructions; the
# forward's (`Dropout::keep_p` and the select of h or 0) takes the same
# multiplies and FWD_HASH_ALU_OPS others
HASH_IMAD_OPS = 2
HASH_ALU_OPS = 9
FWD_HASH_ALU_OPS = 7
# the folded kernels that run their unfolded twin's body on another grid
# (csrc/fwd.cuh, csrc/bwd_q.cuh) and so must give its bits
BIT_EQUAL_TWINS = ("flash_fwd_hf", "flash_bwd_q_hf")
PAD_CYCLES = 2_000_000          # ~1 ms of device spin at the H100's clocks
KERNEL_TOL = dict(rtol=1e-4, atol=1e-5)   # f32, sums in another order
# CUDA vs the CPU path after 10 layers. Through the randomly initialised SBM
# model at N=1024 float32 rounding grows layer by layer on either float32
# route, by an amount that depends on the input: 1e-4 in the logits with
# the canonical LapPE signs, and 2.7e-3 between the two routes on another
# host's signs. So its CUDA logits are held to the CPU in float64, not to
# the CPU's float32 route; the ZINC and SAN models' errors stay near 1e-5
# and are held to float32
SLICE_TOL = dict(rtol=1e-3, atol=1e-3)
# the fused attention kernels', colstat's and the fused MLP kernels'
# outputs against a float64 run of the plain version: each within this
# multiple of the CPU float32 route's own error (a tolerance check alone
# let a kernel output through at 17.7x, PERF.md)
FUSED_CPU32_FACTOR = 2
# one training step on CUDA (float32) vs the CPU route in float64: loss
# within rtol 1e-5; each named gradient within 1e-2 of its largest entry.
# From random weights the gradients reach |g| ~ 40 through 10 layers at
# N=1024, and f32 rounding in the forward is amplified on the way back; the
# CPU's own float32 route is printed beside it for scale. The SBM step's
# loss moves further: over its canonical LapPE signs and 8 random sign
# patterns (`python3 chip_smoke.py --rounding`) float32 rounding put it up
# to 1.46e-5 off the float64 loss on the H100 and 6.66e-6 on the CPU, so it
# is held at about three times that
STEP_LOSS_RTOL = 1e-5
SBM_STEP_LOSS_RTOL = 5e-5
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
TIMED_EPOCHS = 10
# kernel checks: (B, N, padding); the JSON rows are those of the first
# shape, the training batch, whose steps make most of the counted launches;
# the last is the ZINC batch, which the "flash" route runs at N=48
CHECK_SHAPES = ((N_GRAPHS // 2, N_NODES, 60), (N_GRAPHS, N_NODES, 60),
                (N_GRAPHS, 200, 9), (128, 48, 11))
# the bf16 compute policy's kernel checks (`check_bf16_kernels`): (B, N,
# padding) of the batches the bf16 paths give the kernels, the SBM
# training batch (the JSON rows' shape), the SBM request and the ZINC
# batch, whose partial key tiles take the one-element staging and the edge
# masks; pe and deg in bf16 and in float32, at D=64 (value widths 64 and
# 8) and, on the first shape, at the OGB width D=128 (128 and 16)
PEAK_BF16_FLOPS = 989e12        # bf16 on the tensor cores, dense
BF16_SHAPES = ((N_GRAPHS // 2, N_NODES, 60), (N_GRAPHS, N_NODES, 60),
               (128, 48, 11))
BF16_CHECKS = ((64, (64, 8)), (128, (128, 16)))
# (D, dv, pe dtype): held to float64 on the first and the last shape (each
# costs the CPU plain bf16 route at the full shape), and timed on the
# first (the first gives the JSON row)
BF16_F64 = ((64, 64, torch.bfloat16), (64, 8, torch.float32),
            (128, 128, torch.bfloat16))
BF16_TIMED = ((64, 64, torch.bfloat16), (64, 64, torch.float32),
              (128, 128, torch.bfloat16))
# a bf16 kernel against its plain bf16 version on the card: both round P,
# ds, attn and the outputs to bf16 after float32 sums taken in other
# orders, so an output next to a rounding edge may land one bf16 step
# (at most 2^-7 of its size) away; two steps and a small floor. The
# forward's outh besides: the kernel rounds P against its running row
# maximum (as the JAX kernel does, per key block), the plain version
# against the whole row's, so each P may differ by one rounding (2^-8 of
# it) and outh, a P-weighted mean of vw, by up to 2^-8 max|vw|
# (`bf16_outh_tol`, as tests/test_torch_mixed_precision.py holds the
# plain version to the JAX kernel); over ~1000 keys these differences
# average out, over the ZINC batch's 9-37 they do not
BF16_KERNEL_TOL = dict(rtol=1.6e-2, atol=1e-3)
# a bf16 kernel's error from float64 over the CPU plain bf16 route's
BF16_CPU_FACTOR = 2
# the served logits' and a step's error from float64 under the policy, on
# the card over the CPU plain bf16 route's: both round at the same places
# after float32 sums in other orders, and a flipped rounding grows layer
# by layer on either route
BF16_MODEL_FACTOR = 3
# the route check (`bf16_route_check`): the card under each bf16 route
# (FETA_COMPUTE_DTYPE=bfloat16 with FETA_BF16_MODULATION 1 and 0) against
# the CPU plain version of the same route on the same weights, at a depth
# where rounding has not grown to the output's size. A perturbation of one
# bf16 rounding, the kernel's order against the plain version's, pe in
# float32 or the whole policy off, moves the logits and gradients by the
# same amount (the card's readings: 0.36-1.05 of the largest distance
# between the CPU routes), so each distance is held to BF16_ROUTE_FACTOR
# times the largest of the CPU route's distances from the other two, and
# the route itself by its C entry points. {route: (FETA_COMPUTE_DTYPE,
# FETA_BF16_MODULATION)}
BF16_ROUTES = {"bf16": ("bfloat16", "1"), "bf16 pe f32": ("bfloat16", "0"),
               "f32": (None, None)}
BF16_ROUTE_FACTOR = 2
BF16_ROUTE_LAYERS = 2
BF16_ROUTE_PARAMS = ("encoder.layers.0.qkv", "encoder.layers.1.qkv",
                     "encoder.layers.1.out_proj_kernel",
                     "encoder.coeff_head.gcn_kernel",
                     "classifier.fc2.weight")
# the bf16 phase's SBM requests and epochs under each policy in turns (the
# first epoch a warm-up), and its ZINC rounds (`compare_routes`)
BF16_SBM_ROUNDS = 4
BF16_SBM_EPOCHS = 4
BF16_ZINC_ROUNDS = 3
# the bf16 phase's runs of the fused pair's and the fused MLP's paths
# (`bf16_policy_net`): rounds of one request and one step under each
# policy in turns, the order alternating; then, warm, the requests and
# steps timed under each policy in turns (medians)
BF16_NET_ROUNDS = 2
BF16_NET_TIMED_REQUESTS = 16
BF16_NET_TIMED_STEPS = 6
# graphs held to float64 on the CPU there (logits and one step): the ZINC
# regressor's 16, as `bf16_zinc`'s step (a mean over 2 graphs left the
# card's loss error 4.9x the CPU bf16 route's in one call, its gradients
# 1.5-5x), SANNodeSpectra's 4, the lpe nets' 2 (their CPU float64 and
# plain bf16 routes at full width are most of the phase's time)
BF16_REF_GRAPHS = {"zinc": 16, "san": 4, "lpe": 2}
# the wrappers whose launches a run counts, and their launches per step
KERNELS = {"flash_fwd": fl_mod.flash_fwd, "colstat": cs_mod.colstat,
           "flash_bwd_q": fl_mod.flash_bwd_q,
           "flash_bwd_k": fl_mod.flash_bwd_k,
           "flash_fwd_hf": fl_mod.flash_fwd_hf,
           "flash_bwd_q_hf": fl_mod.flash_bwd_q_hf,
           "flash_bwd_k_hf": fl_mod.flash_bwd_k_hf,
           "fused_mlp_fwd": fm_mod.fused_mlp_fwd,
           "fused_mlp_bwd": fm_mod.fused_mlp_bwd,
           "modulation_fwd": mod_mod.modulation_fwd,
           "modulation_bwd": mod_mod.modulation_bwd,
           "fused_attn_fwd": fa_mod.fused_attn_fwd,
           "fused_attn_bwd": fa_mod.fused_attn_bwd}
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
SAN_TIMED_EPOCHS = 5
SAN_STEP_LAUNCHES = {**NONE, "fused_mlp_fwd": 2, "fused_mlp_bwd": 2}
SAN_STEP_PARAMS = ("embedding_h.weight", "layers.0.attention.Q.weight",
                   "layers.9.attention.E.weight", "layers.9.cheb_weight",
                   "pe_transformer.freq_transformer.ff1_0.kernel",
                   "pe_transformer.freq_transformer.ff2_1.kernel",
                   "mlp_readout.fc_out.weight")
# the lpe phase's eigen-PE heads at their configs' widths: the PATTERN
# net's node head (LPE_dim 16, so the forward's two slabs of 1024 units)
# over 16 SBM graphs padded to N = 188 (SBM_PATTERN's largest), and the
# SAN_EdgeLPE pair head (LPE_dim 8) over 32 ZINC graphs padded to N = 38
# (ZINC's largest molecule): B*N*m and B*N*N*m rows at m = 10
PATTERN_GRAPHS, PATTERN_NODES = 16, 188
EDGE_GRAPHS, EDGE_NODES = 32, 38
PATTERN_ROWS = PATTERN_GRAPHS * PATTERN_NODES * SAN_FREQS
EDGE_ROWS = EDGE_GRAPHS * EDGE_NODES ** 2 * SAN_FREQS
# fused-MLP checks: (rows, d_in, F, d_out, rates, tag); the JSON rows are
# those of the "main" shape at dropout 0.1, the training path's, with its
# forward at rate 0 (`*_rate0`) and the tagged shapes' times at rate 0.1
# (`*_d16`, `*_pairs`) beside
MLP_SHAPES = ((SAN_ROWS, 8, 2048, 8, (0.0, 0.1), "main"),
              (10007, 8, 2048, 8, (0.0, 0.1), None),
              (PATTERN_ROWS, 16, 2048, 16, (0.0, 0.1), "d16"),
              (EDGE_ROWS, 8, 2048, 8, (0.1,), "pairs"))
# the fused MLP pair's bf16 checks (`check_bf16_mlp`), the same heads: the
# SAN head's 40,960 rows at d 8 (rates 0 and 0.1), the PATTERN node head's
# 30,080 at d 16 and the SAN_EdgeLPE pair head's 462,080 (rate 0.1)
BF16_MLP_SHAPES = (MLP_SHAPES[0], (PATTERN_ROWS, 16, 2048, 16, (0.1,), "d16"),
                   MLP_SHAPES[3])
# DiffGraphTransformerGenGCN at bench.py's flagship widths (bench.py:133-136)
# on its ZINC batch: 128 zinc_like_dataset graphs of 9-37 nodes padded to 48
ZINC_CFG = dict(in_size=28, nb_class=1, d_model=64, nb_heads=8,
                dim_feedforward=128, dropout=0.0, nb_layers=10,
                batch_norm=True, lap_pos_enc=True, lap_pos_enc_dim=8,
                filter_order=4)
ZINC_GRAPHS = 128
ZINC_NODES = 48
ZINC_REQUESTS = 4
# (requests, warm-up epochs, timed epochs) of each attention route; the
# "fused" route is the slice's main path, the other two are its comparison
ZINC_RUNS = {"fused": (ZINC_REQUESTS, 3, 10), "modulation": (2, 1, 4),
             "flash": (2, 1, 4)}
ZINC_ROUNDS = 5     # interleaved rounds of the routes' comparison
ZINC_REQUEST_LAUNCHES = {
    "fused": {**NONE, "fused_attn_fwd": 9, "modulation_fwd": 1},
    "modulation": {**NONE, "modulation_fwd": 10},
    "flash": {**NONE, "flash_fwd": 10, "colstat": 2}}
ZINC_STEP_LAUNCHES = {
    "fused": {**NONE, "fused_attn_fwd": 9, "fused_attn_bwd": 9,
              "modulation_fwd": 1, "modulation_bwd": 1},
    "modulation": {**NONE, "modulation_fwd": 10, "modulation_bwd": 10},
    "flash": STEP_LAUNCHES}
# checks of the modulation kernels: (B, N, padding) at H=8, the ZINC batch,
# the SBM-PATTERN shape (bench.py:267), the SBM slice's N=1024 and the `r4`
# setting's request and step at N=2048; the fused kernels take N <= 128,
# so the first two. The modulation kernels' outputs are held to float64
# at MOD_F64_SHAPES
MOD_SHAPES = ((ZINC_GRAPHS, ZINC_NODES, 11), (32, 128, 17), (4, 1024, 60),
              (2, 2048, 60), (1, 2048, 100))
MOD_F64_SHAPES = (MOD_SHAPES[0], MOD_SHAPES[-1])
FUSED_SHAPES = MOD_SHAPES[:2]
# The SBM model at N=2048 (examples/largen_combo_ab.py, the JAX package's
# measurement of its head-folded kernels: sbm_like_dataset(seed=2,
# n_nodes=2048), widths not cut): 4 graphs of 1792-2048 nodes, served two
# at a time and trained one at a time, under the three settings of the
# attention dispatch that mirror that script's Pallas combos (JAX's
# FETA_FLASH_HEAD_FOLD / FETA_FLASH_NEED_HEADS)
LARGE_N = 2048
LARGE_GRAPHS = 4
# the N=1024 model cut from 10 layers to 5 at N=2048, to keep the script
# within its time limit (the float64 CPU references scale with the depth)
LARGE_LAYERS = 5
LARGE_CFG = dict(MODEL_CFG, nb_layers=LARGE_LAYERS)
LARGE_STEP_PARAMS = tuple(p.replace("layers.9.", f"layers.{LARGE_LAYERS - 1}.")
                          for p in STEP_PARAMS)
LARGE_SETTINGS = {"fold": dict(head_fold=True, flash_need_heads=True),
                  "stream": dict(head_fold=False, flash_need_heads=True),
                  "r4": dict(head_fold=False, flash_need_heads=False)}
# (requests, warm-up epochs, timed epochs) of each setting; "fold" is the
# slice's main path, the other two its comparison
LARGE_RUNS = {"fold": (2, 2, 5), "stream": (2, 1, 2), "r4": (2, 1, 2)}
LARGE_ROUNDS = 3
# The N=2048 model from random weights amplifies float32 rounding beyond
# the SBM tolerances on the CPU's float32 route too: over 5 LapPE sign
# patterns (`--rounding`) the CPU's own step misses the gradient tolerance
# on some. So at N=2048 the logits and the parity step are held to float64
# within SLICE_TOL and the SBM tolerances, or, where float32 rounding
# exceeds those, within a multiple of the error of the CPU's float32 route
# on the same input, a witness that shares no operation with the card:
# the sweep's worst ratios at 10 layers, rounded up (logits 1.70, a step's
# gradients 3.99 on one pattern, 1.04 or less on the others). `--precision` shows
# where the card's float32 parts from the CPU's, layer by layer
LOGITS_CPU32_FACTOR = 2
STEP_CPU32_FACTOR = 4
LARGE_REQUEST_LAUNCHES = {
    "fold": {**NONE, "flash_fwd_hf": LARGE_LAYERS, "colstat": 2},
    "stream": {**NONE, "flash_fwd": LARGE_LAYERS, "colstat": 2},
    "r4": {**NONE, "flash_fwd": LARGE_LAYERS - 1, "modulation_fwd": 1}}
LARGE_STEP_LAUNCHES = {
    "fold": {**NONE, "flash_fwd_hf": LARGE_LAYERS, "colstat": 2,
             "flash_bwd_q_hf": LARGE_LAYERS, "flash_bwd_k_hf": LARGE_LAYERS},
    "stream": {**NONE, "flash_fwd": LARGE_LAYERS, "colstat": 2,
               "flash_bwd_q": LARGE_LAYERS, "flash_bwd_k": LARGE_LAYERS},
    "r4": {**NONE, **{k: LARGE_LAYERS - 1 for k in
                      ("flash_fwd", "flash_bwd_q", "flash_bwd_k")},
           "modulation_fwd": 1, "modulation_bwd": 1}}
# checks of the head-folded kernels: (B, N, padding) at the training shape,
# the serving shape and a ragged N; the JSON rows are the first shape's
HF_SHAPES = ((1, LARGE_N, 100), (2, LARGE_N, 60), (2, 1990, 9))
# The OGB molhiv classifier at its CLI's widths
# (feta_tmlr_tpu/experiments/run_transformer_gengcn_molhiv.py:42-77 with
# experiments/common.py's defaults: d_model 128, 8 heads, 4 layers, ff 256,
# dropout 0, Chebyshev order 4, the last layer filtered, no batch norm, no
# PE), random weights from a seed, on the "flash" route: the unfolded
# kernels at D = 128 (dv 128 on the three unfiltered layers, 16 on the
# filtered one). Requests of 128 ogb_like_dataset molecules (the CLI's
# synthetic fallback, 8-27 atoms), padded to their own largest molecule and
# to N = 222, the largest molecule of ogbg-molhiv, which the CLI pads real
# batches to; the 10 molecules of tests/fixtures/ogbg_molhiv; 3 training
# steps (binary_graph, sigmoid BCE, warmup)
MOLHIV_CFG = dict(nb_class=1, d_model=128, nb_heads=8, dim_feedforward=256,
                  dropout=0.0, nb_layers=4, batch_norm=False,
                  filter_order=4)
MOLHIV_GRAPHS = 128
MOLHIV_REAL_N = 222
MOLHIV_REQUESTS = 3
MOLHIV_STEPS = 3
# served graphs held to the float64 CPU forward at N = 222: every 16th
# (at the batch's own padding, and of the fixture's 10, all of them)
MOLHIV_REF_STRIDE = 16
MOLHIV_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "fixtures")
MOLHIV_REQUEST_LAUNCHES = {**NONE, "flash_fwd": 4, "colstat": 2}
MOLHIV_STEP_LAUNCHES = {**NONE, "flash_fwd": 4, "colstat": 2,
                        "flash_bwd_q": 4, "flash_bwd_k": 4}
MOLHIV_STEP_PARAMS = ("embedding.atom_emb_0.weight", "encoder.layers.0.qkv",
                      "encoder.layers.3.qkv",
                      "encoder.layers.3.out_proj_kernel",
                      "encoder.coeff_head.gcn_kernel", "cls_fc2.weight")
# the unfolded kernels at the molhiv width: (B, N, padding) at the SBM
# slice's training shape, beside the D = 64 rows, and at the molhiv
# request padded to N = 222 (ragged; 20-27 real nodes a graph, as
# ogb_like_dataset's molecules); the `*_d128` fields of the JSON rows are
# the first shape's at dv = 128
WIDE_D = 128
WIDE_SHAPES = ((N_GRAPHS // 2, N_NODES, 60), (MOLHIV_GRAPHS, MOLHIV_REAL_N,
                                              MOLHIV_REAL_N - 27))
# the cli phase: the port's command-line entry points as a user runs them
# (module main()s with argv, in this process so the launch counters see
# them): the config-driven trainer on the ZINC fixture at
# configs/LPE/ZINC/optimized.json's widths, serve_main from its checkpoint
# answering HTTP requests on 127.0.0.1, feta-zinc at bench.py's widths on
# the ZINC fixture and feta-molhiv at d_model 128 on its synthetic fallback
CLI_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "LPE", "ZINC", "optimized.json")
CLI_FIXTURES = MOLHIV_FIXTURES
CLI_EPOCHS = 2
# feta-torch-zinc on the ZINC fixture (the cli phase; the bf16 phase under
# FETA_COMPUTE_DTYPE=bfloat16)
CLI_ZINC_ARGV = ["--datadir", CLI_FIXTURES, "--lappe", "--lap-dim", "8",
                 "--pos-enc", "diffusion"]
CLI_REQUESTS = 8
CLI_REQUEST_GRAPHS = 32
CLI_MAX_NODES = 64            # serve_main's default padded size
CLI_SERVE_TOL = 1e-5          # served logits against an in-process Predictor
CLI_WINDOW_CHUNK = 16         # the window check's chunk: 16 chunks a request
CLI_TIMED_REQUESTS = 100      # requests timed after the checked ones
CLI_STAGE_REPS = 50           # in-process runs of one request's stages
CLI_LOG_COLUMNS = {"config": ["epoch", "loss", "time", "val_mae", "lr"],
                   "config_lpe": ["epoch", "loss", "time", "val_mae", "lr"],
                   "config_lpe_bf16": ["epoch", "loss", "time", "val_mae",
                                       "lr"],
                   "config_gat": ["epoch", "loss", "time", "val_mae", "lr"],
                   "sbm_lpe": ["epoch", "loss", "time", "val_acc_sbm", "lr"],
                   "molhiv_lpe": ["epoch", "loss", "time", "val_rocauc",
                                  "lr"],
                   "zinc": ["epoch", "loss", "time", "val_mae", "lr"],
                   "zinc_bf16": ["epoch", "loss", "time", "val_mae", "lr"],
                   "molhiv": ["epoch", "loss", "time", "val_rocauc"],
                   "sbm": ["epoch", "loss", "time", "val_acc_sbm"],
                   "tu": ["epoch", "loss", "time", "val_acc"],
                   "config_lspe": ["epoch", "loss", "time", "val_mae", "lr"],
                   "lapeig_lspe": ["epoch", "loss", "time", "val_mae", "lr"],
                   "pattern_lspe": ["epoch", "loss", "time", "val_acc_sbm",
                                    "lr"],
                   "ogbmol_lspe": ["epoch", "loss", "time", "val_ap", "lr"],
                   "graphit_zinc": ["epoch", "loss", "time", "val_mae", "lr"],
                   "graphit_vanilla": ["epoch", "loss", "time", "val_mae",
                                       "lr"],
                   "graphit_gcn": ["epoch", "loss", "time", "val_mae", "lr"],
                   "graphit_cv": ["epoch", "loss", "time", "val_acc"],
                   "graphit_gcn_cv": ["epoch", "loss", "time", "val_acc"],
                   "graphit_sbm": ["epoch", "loss", "time", "val_acc_sbm"],
                   "graphit_molhiv": ["epoch", "loss", "time",
                                      "val_rocauc"],
                   "zinc_arma": ["epoch", "loss", "time", "val_mae", "lr"],
                   "zinc_every": ["epoch", "loss", "time", "val_mae", "lr"],
                   "tu_san": ["epoch", "loss", "time", "val_acc", "lr"],
                   "tu_lspe": ["epoch", "loss", "time", "val_acc", "lr"],
                   "zinc_packed": ["epoch", "loss", "time", "val_mae", "lr"],
                   "molpcba": ["epoch", "loss", "time", "val_ap"],
                   "pcqm4m": ["epoch", "loss", "time", "val_mae"],
                   "zinc_gckn": ["epoch", "loss", "time", "val_mae", "lr"],
                   "gckn_cv": ["epoch", "loss", "time", "val_acc"],
                   "gckn_sbm": ["epoch", "loss", "time", "val_acc_sbm"],
                   "gckn_molpcba": ["epoch", "loss", "time", "val_ap"],
                   "gckn_graphit_zinc": ["epoch", "loss", "time", "val_mae",
                                         "lr"],
                   "gckn_graphit_cv": ["epoch", "loss", "time", "val_acc"],
                   "gckn_graphit_sbm": ["epoch", "loss", "time",
                                        "val_acc_sbm"],
                   "gckn_graphit_molhiv": ["epoch", "loss", "time",
                                           "val_rocauc"],
                   "gat_b128": ["epoch", "loss", "time", "val_mae", "lr"]}
FLASH_ROUTE = {"flash_fwd", "colstat", "flash_bwd_q", "flash_bwd_k"}
MLP_ROUTE = {"fused_mlp_fwd", "fused_mlp_bwd"}
CLI_KERNELS = {"config": MLP_ROUTE, "config_lpe": MLP_ROUTE,
               "config_gat": set(), "sbm_lpe": MLP_ROUTE,
               "molhiv_lpe": MLP_ROUTE,
               "zinc": FLASH_ROUTE, "zinc_bf16": FLASH_ROUTE,
               "config_lpe_bf16": MLP_ROUTE,
               "molhiv": FLASH_ROUTE,
               "sbm": FLASH_ROUTE, "tu": FLASH_ROUTE, "config_lspe": set(),
               "lapeig_lspe": set(), "pattern_lspe": set(),
               "ogbmol_lspe": set(),
               **dict.fromkeys(("graphit_zinc", "graphit_vanilla",
                                "graphit_gcn", "graphit_cv",
                                "graphit_gcn_cv", "graphit_sbm",
                                "graphit_molhiv"), FLASH_ROUTE - {"colstat"}),
               "zinc_arma": FLASH_ROUTE, "zinc_every": FLASH_ROUTE,
               "tu_san": MLP_ROUTE, "tu_lspe": set(),
               "zinc_packed": set(), "molpcba": FLASH_ROUTE,
               "pcqm4m": FLASH_ROUTE,
               **dict.fromkeys(("zinc_gckn", "gckn_cv", "gckn_sbm",
                                "gckn_molpcba"), FLASH_ROUTE),
               **dict.fromkeys(("gckn_graphit_zinc", "gckn_graphit_cv",
                                "gckn_graphit_sbm", "gckn_graphit_molhiv"),
                               FLASH_ROUTE - {"colstat"}),
               "gckn_sup": set(), "gckn_sup_cv": set(), "gat_b128": set()}
# the lpe phase: the LPE codebase's other nets at their configs' widths,
# built by the port's config trainers (resolve_build / construct_model),
# random weights from a seed, each served (LPE_REQUESTS requests of its
# batch through Predictor, the first LPE_REF_GRAPHS graphs held to a
# float64 CPU forward) and trained (2 batches, LPE_EPOCHS warm-up epochs
# and LPE_TIMED_EPOCHS timed ones, then one step on LPE_REF_GRAPHS graphs
# held to a float64 CPU step, the eigen-PE dropout 0.1 on in every route:
# the masks are the same bits on the CPU and the card). (label, config,
# net_params overrides, trainer, graphs a batch, padded nodes, fused-MLP
# launches a request and a step, gradients held)
ROOT = os.path.dirname(os.path.abspath(__file__))
LPE_REQUESTS = 3
LPE_EPOCHS = 2
LPE_TIMED_EPOCHS = 3
LPE_REF_GRAPHS = 4
LPE_NETS = (
    ("SAN_NodeLPE", "configs/LPE/ZINC/optimized.json", {}, "zinc", 32,
     EDGE_NODES, 2, ("embedding_h.weight", "layers.0.attention.Q.weight",
                     "layers.9.attention.E.weight",
                     "pe_transformer.freq_transformer.ff1_0.kernel",
                     "pe_transformer.freq_transformer.ff2_1.kernel",
                     "mlp_readout.fc_out.weight")),
    ("PATTERN SAN_NodeLPE", "configs/LPE/PATTERN/optimized.json", {}, "sbm",
     PATTERN_GRAPHS, PATTERN_NODES, 3,
     ("embedding_h.weight", "layers.0.attention.Q_2.weight",
      "layers.3.ffn2.weight", "pe_transformer.freq_transformer.ff1_0.kernel",
      "pe_transformer.freq_transformer.ff2_2.kernel",
      "mlp_readout.fc_out.weight")),
    ("SAN_EdgeLPE", "configs/LPE/ZINC/optimized.json", {"LPE": "edge"},
     "zinc", EDGE_GRAPHS, EDGE_NODES, 2,
     ("embedding_e.weight", "layers.0.attention.E.weight",
      "layers.9.attention.K_2.weight",
      "pe_transformer.freq_transformer.linear_A.weight",
      "pe_transformer.freq_transformer.ff1_1.kernel",
      "mlp_readout.fc_out.weight")),
    ("GATFeTA", "configs/LPE/ZINC_GATFeTA_optimized.json", {}, "zinc", 128,
     EDGE_NODES, 0, ("embedding_h.weight", "layers.0.gatconv.fc.weight",
                     "layers.15.gatconv.attn_l", "layers.15.cheb_weight",
                     "layers.15.coeff_head.gcn_linear.weight",
                     "mlp_readout.fc_out.weight")),
)
# the bf16 phase's models on the fused MLP pair, one lpe net at a time
# (`bf16_lpe`): SANNodeSpectra at SAN_CFG (the san phase's widths) and
# the lpe phase's four nets; the route check at BF16_ROUTE_LAYERS layers
# reads these SANNodeSpectra gradients
BF16_SAN_ROUTE_PARAMS = ("layers.0.attention.Q.weight",
                         "layers.1.attention.Q_2.weight",
                         "layers.1.cheb_weight",
                         "pe_transformer.freq_transformer.ff1_0.kernel",
                         "mlp_readout.fc_out.weight")
# the cli phase's runs of the LPE configs as written (no --model override)
CLI_LPE_RUNS = (
    ("config_lpe", cli_zinc_config.main,
     ["--config", os.path.join(ROOT, "configs/LPE/ZINC/optimized.json"),
      "--data-dir", CLI_FIXTURES]),
    ("config_gat", cli_zinc_config.main,
     ["--config", os.path.join(ROOT, "configs/LPE/ZINC/optimized_gat_1.json"),
      "--data-dir", CLI_FIXTURES]),
    ("sbm_lpe", cli_sbm_config.main,
     ["--config", os.path.join(ROOT, "configs/LPE/CLUSTER/optimized.json"),
      "--data-dir", CLI_FIXTURES]),
    ("molhiv_lpe", cli_molhiv_config.main,
     ["--config", os.path.join(
         ROOT, "configs/LPE/MOLHIV/optimized_spectral_full_1.json"),
      "--data-dir", CLI_FIXTURES]),
)
# the lspe phase: the LSPE codebase's nets at their configs' widths and
# depths, built by the port's config trainers (with --model where given),
# random weights from a seed, each served (LPE_REQUESTS requests of its
# batch through Predictor, the first LPE_REF_GRAPHS graphs held to a
# float64 CPU forward) and trained (2 batches, LPE_EPOCHS warm-up and
# LPE_TIMED_EPOCHS timed epochs, then one step on LPE_REF_GRAPHS graphs
# held to a float64 CPU step). They run no TPU kernel: every launch counter
# reads 0. A run on COO batches is also held to its dense twin. (label,
# config, --model, model kwargs, trainer, graphs a batch, padded nodes, COO
# batches, dense twin, gradients held)
LSPE_NETS = (
    ("GraphiTSpectra", "configs/LSPE/GraphiT_ZINC_LSPE.json",
     "GraphiTSpectra", {}, "zinc", 32, EDGE_NODES, False, None,
     ("embedding_h.weight", "embedding_p.weight",
      "layers.0.attention_h.Q.weight", "layers.9.attention_p.E_2.weight",
      "layers.9.cheb_weight", "Whp.weight", "mlp_readout.fc_out.weight")),
    ("PATTERN Spectra", "configs/LSPE/GraphiT_SBM_PATTERN_LSPE.json", None,
     {}, "sbm", PATTERN_GRAPHS, PATTERN_NODES, False, None,
     ("embedding_h.weight", "layers.0.attention_h.Q_2.weight",
      "layers.5.coeff_head.gcn_linear.weight", "layers.9.O_p.weight",
      "p_out.weight", "mlp_readout.fc_out.weight")),
    ("SAN_LSPE", "configs/LSPE/SAN_ZINC_LSPE.json", None, {}, "zinc", 32,
     EDGE_NODES, False, None,
     ("gamma", "embedding_e.weight", "layers.0.attention_h.Q.weight",
      "layers.9.attention_p.K_2.weight", "layers.9.ffn2.weight",
      "mlp_readout.fc_out.weight")),
    ("GatedGCN", "configs/LSPE/GatedGCN_ZINC_LSPE.json", None, {}, "zinc",
     128, EDGE_NODES, False, None,
     ("embedding_h.weight", "embedding_e.weight", "layers.0.A1.weight",
      "layers.7.B3.weight", "layers.15.C2.weight",
      "layers.15.bn_node_h.scale", "Whp.weight")),
    ("GatedGCN sparse", "configs/LSPE/GatedGCN_ZINC_LSPE.json", None, {},
     "zinc", 128, EDGE_NODES, True, "GatedGCN",
     ("embedding_h.weight", "embedding_e.weight", "layers.0.A1.weight",
      "layers.7.B3.weight", "layers.15.C2.weight",
      "layers.15.bn_node_h.scale", "Whp.weight")),
    ("PNA", "configs/LSPE/PNA_ZINC_LSPE.json", None, {}, "zinc", 128,
     EDGE_NODES, False, None,
     ("embedding_e.weight", "embedding_p.weight",
      "layers.0.towers.pretrans_h.fc_out.kernel",
      "layers.8.mixing_h.weight",
      "layers.15.towers.posttrans_p.fc_out.kernel",
      "layers.15.towers.batchnorm_h.scale", "Whp.weight")),
    ("PNA sparse", "configs/LSPE/PNA_ZINC_LSPE.json", None,
     {"sparse_edges": True}, "zinc", 128, EDGE_NODES, True, "PNA",
     ("embedding_e.weight", "embedding_p.weight",
      "layers.0.towers.pretrans_h.fc_out.kernel",
      "layers.8.mixing_h.weight",
      "layers.15.towers.posttrans_p.fc_out.kernel",
      "layers.15.towers.batchnorm_h.scale", "Whp.weight")),
)
# the cli phase's LSPE runs of configs as written: 2 epochs into a
# checkpoint directory and a resume to 4, held bit for bit to 4 epochs in
# one run
CLI_LSPE_RUNS = (
    ("lapeig_lspe", cli_zinc_config.main,
     ["--config", os.path.join(
         ROOT, "configs/LSPE/GatedGCN_ZINC_LSPE_withLapEigLoss.json"),
      "--data-dir", CLI_FIXTURES]),
    ("pattern_lspe", cli_sbm_config.main,
     ["--config", os.path.join(
         ROOT, "configs/LSPE/GraphiT_SBM_PATTERN_LSPE.json"),
      "--data-dir", CLI_FIXTURES]),
    ("ogbmol_lspe", cli_ogbmol_config.main,
     ["--config", os.path.join(
         ROOT, "configs/LSPE/GatedGCN_MOLPCBA_LSPE.json"),
      "--data-dir", CLI_FIXTURES]),
)
# the cli phase's GraphiT runs: the six baseline CLIs at their defaults
# (ZINC and TU fixtures with --lappe, the SBM fixture, molhiv on its
# synthetic fallback), feta-zinc with the ARMA filter and with the filter in
# every layer, and the TU config trainer with a SAN and an LSPE config
CLI_GRAPHIT_RUNS = (
    ("graphit_zinc", cli_graphit.main,
     ["--datadir", CLI_FIXTURES, "--lappe", "--pos-enc", "diffusion"]),
    ("graphit_vanilla", cli_graphit.main,
     ["--datadir", CLI_FIXTURES, "--lappe", "--vanilla"]),
    ("graphit_gcn", cli_graphit_gcn.main,
     ["--datadir", CLI_FIXTURES, "--lappe", "--pos-enc", "diffusion"]),
    ("graphit_cv", cli_graphit_cv.main,
     ["--datadir", CLI_FIXTURES, "--dataset", "TUFIX", "--lappe"]),
    ("graphit_gcn_cv", cli_graphit_gcn_cv.main,
     ["--datadir", CLI_FIXTURES, "--dataset", "TUFIX", "--lappe"]),
    ("graphit_sbm", cli_graphit_sbm.main,
     ["--datadir", CLI_FIXTURES, "--dataset", "FIXTURE", "--lappe"]),
    ("graphit_molhiv", cli_graphit_molhiv.main, ["--datadir", "no-dataset"]),
    ("zinc_arma", cli_zinc.main,
     ["--datadir", CLI_FIXTURES, "--lappe", "--pos-enc", "diffusion",
      "--gnn_type", "ARMAConvDynamic"]),
    ("zinc_every", cli_zinc.main,
     ["--datadir", CLI_FIXTURES, "--lappe", "--pos-enc", "diffusion",
      "--last_layer_filter"]),
    ("tu_san", cli_tu_config.main,
     ["--config", os.path.join(ROOT, "configs/LPE/ZINC/optimized.json"),
      "--dataset", "TUFIX", "--datadir", CLI_FIXTURES]),
    ("tu_lspe", cli_tu_config.main,
     ["--config", os.path.join(ROOT, "configs/LSPE/GraphiT_ZINC_LSPE.json"),
      "--model", "GraphiT", "--dataset", "TUFIX", "--datadir",
      CLI_FIXTURES]),
)
# the cli phase's runs of packed batches and the last two FeTA OGB CLIs:
# feta-zinc --packed on the ZINC fixture (no kernel: packed rows take the
# plain pair-masked attention), feta-molpcba on CLI_MOLPCBA_GRAPHS synthetic
# molecules (2 training batches of its CLI's 256) and feta-pcqm4m on the LSC
# fixture through data/smiles.py, each 2 epochs and a resume to 4 held bit
# for bit to 4 epochs in one run. (label, main, argv, the run's training,
# validation and test batches, from which `cli_flash_launches` counts its
# exact #1-#4 launches, or None where no kernel may launch)
CLI_MOLPCBA_GRAPHS = 640      # 512 / 64 / 64
CLI_OGB_RUNS = (
    ("zinc_packed", cli_zinc.main,
     ["--datadir", CLI_FIXTURES, "--lappe", "--pos-enc", "diffusion",
      "--packed"], None),
    ("molpcba", cli_molpcba.main,
     ["--datadir", "no-dataset", "--synthetic-graphs",
      str(CLI_MOLPCBA_GRAPHS)], (2, 1, 1)),
    ("pcqm4m", cli_pcqm4m.main, ["--datadir", CLI_FIXTURES], (1, 1, 1)),
)
# the cli phase's GCKN runs: feta-zinc-gckn at its defaults (paths of 8
# nodes, 100,000 sampled paths, 10 layers of width 64) on the ZINC fixture,
# 2 epochs and a resume to 4 held bit for bit to 4 epochs in one run (the
# GCKN codes are recomputed in each run); then each other GCKN CLI once,
# CLI_EPOCHS epochs at its defaults on a fixture or CLI_GCKN_GRAPHS
# synthetic graphs, k-means over CLI_GCKN_SAMPLES sampled paths
CLI_GCKN_SAMPLES = ["--n-sampling-paths", "10000"]
CLI_GCKN_GRAPHS = ["--synthetic-graphs", "64"]
CLI_GCKN_RUNS = (
    ("gckn_cv", cli_gckn_cv.main,
     ["--datadir", CLI_FIXTURES, "--dataset", "TUFIX", "--gckn-agg"]),
    ("gckn_sbm", cli_gckn_sbm.main,
     ["--datadir", CLI_FIXTURES, "--dataset", "FIXTURE"]),
    ("gckn_molpcba", cli_gckn_molpcba.main,
     ["--datadir", "no-dataset"] + CLI_GCKN_GRAPHS),
    ("gckn_graphit_zinc", cli_gckn_graphit.main, ["--datadir", CLI_FIXTURES]),
    ("gckn_graphit_cv", cli_gckn_graphit_cv.main,
     ["--datadir", CLI_FIXTURES, "--dataset", "TUFIX"]),
    ("gckn_graphit_sbm", cli_gckn_graphit_sbm.main,
     ["--datadir", CLI_FIXTURES, "--dataset", "FIXTURE"]),
    ("gckn_graphit_molhiv", cli_gckn_graphit_molhiv.main,
     ["--datadir", "no-dataset"] + CLI_GCKN_GRAPHS),
    ("gckn_sup", cli_gckn_sup.main, CLI_GCKN_GRAPHS),
    ("gckn_sup_cv", cli_gckn_sup_cv.main,
     ["--datadir", "no-dataset"] + CLI_GCKN_GRAPHS),
)
# the LPE codebase's GAT config as written (16 layers, batch 128) on 320
# synthetic ZINC molecules (2 training batches of 128 graphs, ~4,000 atom
# ids each), 2 epochs and a resume to 4 held bit for bit to 4 epochs in
# one run: the table gradients of `nn/san.py::embedding()` are one-hot
# products (nn/lookup.py), not atomic sums
CLI_GAT_B128 = ("gat_b128", cli_zinc_config.main,
                ["--config", os.path.join(ROOT,
                                          "configs/LPE/ZINC/optimized_gat_1.json"),
                 "--data-dir", "no-dataset", "--synthetic-graphs", "320"])
# serve_main from a GraphiT-Spectra-LSPE checkpoint of the ZINC trainer
CLI_LSPE_SERVE = os.path.join(ROOT, "configs/LSPE/GraphiT_ZINC_LSPE.json")
# the graphit phase: the GraphiT baselines and the FeTA filter's options
# at bench.py's ZINC widths (ZINC_CFG) on 2 batches of 128 zinc_like_dataset
# graphs padded to 48, and the molhiv baseline at MOLHIV_CFG's widths on 128
# ogb_like_dataset molecules; random weights from a seed. Each serves
# GRAPHIT_REQUESTS requests through Predictor (the first GRAPHIT_REF_GRAPHS
# graphs held to a float64 CPU forward) and trains GRAPHIT_STEPS steps
# through Trainer (finite loss, no host sync), then one step on 16 graphs
# is held to a float64 CPU step. (label, class, its keyword arguments,
# route, data, launches a request, launches a step, gradients held)
GRAPHIT_REQUESTS = 3
GRAPHIT_STEPS = 10
GRAPHIT_REF_GRAPHS = 8
BASE_CFG = {k: v for k, v in ZINC_CFG.items() if k != "filter_order"}
VANILLA_CFG = {k: v for k, v in BASE_CFG.items() if k != "batch_norm"}
MOLHIV_BASE_CFG = {k: v for k, v in MOLHIV_CFG.items()
                   if k not in ("nb_class", "filter_order")}
FLASH_10 = {**NONE, "flash_fwd": 10}
FLASH_10_STEP = {**NONE, "flash_fwd": 10, "flash_bwd_q": 10,
                 "flash_bwd_k": 10}
FUSED_10 = {**NONE, "fused_attn_fwd": 10}
FUSED_10_STEP = {**NONE, "fused_attn_fwd": 10, "fused_attn_bwd": 10}
BASE_PARAMS = ("layers.0.qkv", "layers.9.qkv", "layers.9.out_proj_kernel",
               "layers.9.ff2.weight", "classifier.fc2.weight")
GRAPHIT_NETS = (
    ("DiffGraphTransformer flash", DiffGraphTransformer, BASE_CFG, "flash",
     "zinc", FLASH_10, FLASH_10_STEP, BASE_PARAMS),
    ("DiffGraphTransformer fused", DiffGraphTransformer, BASE_CFG, "fused",
     "zinc", FUSED_10, FUSED_10_STEP, BASE_PARAMS),
    ("GraphTransformer flash", GraphTransformer, VANILLA_CFG, "flash",
     "zinc", FLASH_10, FLASH_10_STEP, BASE_PARAMS),
    ("GraphTransformer fused", GraphTransformer, VANILLA_CFG, "fused",
     "zinc", FUSED_10, FUSED_10_STEP, BASE_PARAMS),
    ("GenGCN ARMA", DiffGraphTransformerGenGCN,
     dict(ZINC_CFG, gnn_type="ARMAConvDynamic"), "flash", "zinc",
     {**FLASH_10, "colstat": 2}, {**FLASH_10_STEP, "colstat": 2},
     ("encoder.layers.0.qkv", "encoder.layers.9.qkv",
      "encoder.arma_init_weight", "encoder.arma_root_weight",
      "encoder.coeff_head.gcn_kernel", "classifier.fc2.weight")),
    ("GenGCN every-layer filter", DiffGraphTransformerGenGCN,
     dict(ZINC_CFG, last_layer_filter=False), "flash", "zinc",
     {**FLASH_10, "colstat": 20}, {**FLASH_10_STEP, "colstat": 20},
     ("encoder.layers.0.qkv", "encoder.layers.5.out_proj_kernel",
      "encoder.layers.9.qkv", "encoder.coeff_head.gcn_kernel",
      "encoder.linear_cat.weight", "classifier.fc2.weight")),
    # the recomputed forward of each layer launches its kernels again
    ("GenGCN remat", DiffGraphTransformerGenGCN, dict(ZINC_CFG, remat=True),
     "flash", "zinc", {**FLASH_10, "colstat": 2},
     {**FLASH_10_STEP, "flash_fwd": 20, "colstat": 4}, STEP_PARAMS),
    ("DiffGraphTransformerMolHiv", DiffGraphTransformerMolHiv,
     MOLHIV_BASE_CFG, "flash", "molhiv", {**NONE, "flash_fwd": 4},
     {**NONE, "flash_fwd": 4, "flash_bwd_q": 4, "flash_bwd_k": 4},
     ("embedding.atom_emb_0.weight", "layers.0.qkv", "layers.3.qkv",
      "layers.3.out_proj_kernel", "cls_fc2.weight")),
)
# `--precision`'s backward probe: the canonical signs and the `--rounding`
# sign pattern on which the N=2048 step's CUDA gradients were furthest
# from float64 against the CPU's float32 route (3.99x, PERF.md)
# the packed phase: the flagship ZINC regressor at ZINC_CFG's widths on
# ZINC_GRAPHS zinc_like_dataset graphs packed into rows of PACKED_ROW nodes
# (data/pack.py) against the same graphs padded to ZINC_NODES on the
# "flash" route: PACKED_REQUESTS eval forwards and PACKED_STEPS Trainer
# steps each; every layer of a packed row takes the plain pair-masked
# chain, so the packed path launches no kernel. Packed logits are held to
# the padded model's on the card (same weights) within PACKED_TOL, and to a
# float64 CPU forward within SLICE_TOL; a step on PACKED_STEP_GRAPHS graphs
# to a float64 CPU step
PACKED_ROW = 128
PACKED_REQUESTS = 3
PACKED_STEPS = 10
PACKED_TOL = dict(rtol=1e-4, atol=1e-4)
PACKED_STEP_GRAPHS = 32
# the gckn phase: feta-zinc-gckn's GCKN settings (paths of up to 8 nodes,
# one path layer of 32 anchors, sigma 0.6, sum pooling, k-means over
# 100,000 sampled paths) on GCKN_GRAPHS zinc_like_dataset graphs; the
# card's codes held to a float64 encode on the card and, on the first
# GCKN_CPU_GRAPHS graphs, to the CPU's float32 encode, within GCKN_TOL of
# the largest code; the standardised codes as the lap-PE input of the
# ZINC regressor at ZINC_CFG's widths with lap_pos_enc_dim 32 on the
# "flash" route: one request of the 128 graphs, GCKN_STEPS Trainer steps
# (L1, plateau schedule), one step on 16 graphs held to a float64 CPU
# step; then GCKNSupervised at gckn_sup.py's defaults (paths of 4 nodes,
# hidden 32, sigma 0.5, sum pooling; k-means over GCKN_SUP_SAMPLES paths)
# on GCKN_SUP_GRAPHS graphs: GCKN_SUP_STEPS Adam steps (L1), the first
# step's loss and gradients held to float64 on the card
GCKN_GRAPHS = 128
GCKN_PE = dict(dim=32, path_size=8, kernel_arg=0.6, pooling="sum",
               n_sampling_paths=100000)
GCKN_CFG = dict(ZINC_CFG, lap_pos_enc_dim=GCKN_PE["dim"])
GCKN_TOL = 1e-4
GCKN_CPU_GRAPHS = 16
GCKN_STEPS = 5
GCKN_SUP_GRAPHS = 96
GCKN_SUP_SAMPLES = 20000
GCKN_SUP_STEPS = 5
PROBE_PATTERNS = (0, 4)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, cold: bool = False) -> float:
    """Median device milliseconds of one call, CUDA events around each call.
    Each call is queued behind ~1 ms of device spin, so the host has
    enqueued the start event, the call's kernels and the end event before
    the device reaches them: the events time the device's work, not the
    host's enqueue of it, which for a kernel of tens of microseconds (the
    ZINC batch's) takes as long as the work. `cold`: before each call,
    outside the timed events, a read of twice L2_BYTES, whose clean lines
    evict the call's inputs, so the call reads them from device memory as a
    bound counted at PEAK_BYTES assumes."""
    if cold:
        flush = torch.ones(2 * L2_BYTES // 4, device="cuda")
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cold:
            flush.sum()
        torch.cuda._sleep(PAD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(seed, b, h, n, d, dv, pad, device):
    """Public-layout attention operands from numpy, as the layer makes
    them; graph i loses its last pad + (i mod 8) nodes to padding."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    mask = np.ones((b, n), bool)
    for i in range(b):
        mask[i, n - pad - i % 8:] = False
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


def max_err(got, want, name, tol=KERNEL_TOL):
    """Largest absolute error; raise where |got - want| > atol + rtol|want|
    (bf16 outputs compared in float32)."""
    worst = 0.0
    for g, w in zip(got, want):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite output")
        if g.dtype != w.dtype:
            raise AssertionError(f"{name}: dtype {g.dtype}, plain version "
                                 f"{w.dtype}")
        g, w = g.float(), w.float()
        worst = max(worst, float((g - w).abs().max()))
        if not torch.allclose(g, w, **tol):
            raise AssertionError(f"{name}: kernel and plain version differ "
                                 f"(max abs err {worst:.3e})")
    return worst


def real_counts(mask):
    """(B, N, real nodes, real (query, key) pairs) of a mask [B, N]: the
    attention kernels' work is the score of each pair whose query and key
    are both real; a padded row's outputs are written, not computed."""
    real = (mask > 0).sum(-1).double()
    b, n = mask.shape
    return b, n, float(real.sum()), float((real * real).sum())


def flash_cost(mask, h, d, dv, vb=4, mb=4):
    """(flops, bytes) of the forward on these inputs, counted from the mask
    [B, N]: the score and P·V of each real pair; the real rows of each
    input and the real pairs of pe read once, the whole mask read, each
    output (outh, m, se, su) written once. vb, mb: bytes of an element of
    the values (xa, x, vw, outh) and of pe and deg, 2 for bf16 operands."""
    b, n, rows, pairs = real_counts(mask)
    flops = 2.0 * h * pairs * (d + dv)
    nbytes = (vb * (h * rows * d + rows * d + h * rows * dv + b * h * n * dv)
              + mb * (pairs + rows)
              + 4.0 * (b * n + 2 * h * rows + h + 3 * b * h * n))
    return flops, nbytes


def colstat_cost(mask, h, d, vb=4, mb=4):
    """(flops, bytes) of colstat on these inputs, counted from the mask as
    `flash_cost`: the score of each real pair; the real rows of its inputs
    (with m, se, su and wq) read once, each output written once; vb, mb as
    in `flash_cost`."""
    b, n, rows, pairs = real_counts(mask)
    flops = 2.0 * h * pairs * d
    nbytes = (vb * (h * rows * d + rows * d) + mb * (pairs + rows)
              + 4.0 * (b * n + 2 * h * rows + h + 4 * h * rows
                       + 2 * b * h * n))
    return flops, nbytes


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bound_tc(flops, nbytes, fma_flops):
    """The least time of the arithmetic that a flash kernel issues:
    `fma_flops` (the score) as f32 FMAs on the CUDA cores and the rest as
    TF32_SPLIT TF32 products for each f32 one on the tensor cores, the two
    units side by side; or of its bytes: (ms, what bounds it)."""
    t_ops = max(fma_flops / PEAK_F32_FLOPS,
                TF32_SPLIT * (flops - fma_flops) / PEAK_TF32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def pass_bounds(t, cost, mask, h, d):
    """A flash or fused attention kernel's bounds from its (flops, bytes)
    `cost`. Each takes its score (2·H·D flops a real pair of the mask
    [B, N]) on the CUDA cores as one FMA chain and its other products (the
    forwards one, the query passes two, the key passes three, the fused
    backward four) on the tensor cores in 3xTF32: the bound of what it
    issues (`bound_tc`), which is its `bound_ms`, beside all of it as f32
    FMAs on the CUDA cores; the fields of its JSON row and the text with
    each share of time `t`."""
    (b32, by32) = bound(*cost)
    (btc, bytc) = bound_tc(*cost, 2.0 * h * real_counts(mask)[3] * d)
    text = (f"bound {btc:.4f} ms {bytc} ({100 * btc / t:.2f} %; CUDA-core "
            f"score, 3xTF32 tensor-core products; real pairs only), f32 "
            f"CUDA cores only {b32:.4f} ms {by32} ({100 * b32 / t:.2f} %)")
    return dict(bound_ms=btc, bound_by=bytc, bound_f32_ms=b32), text


def colstat_args(ops, stats, wq):
    """colstat's operands as one list (`cpu32_ratios`' layout)."""
    return [ops[k] for k in ("xa", "x", "cq", "ck", "c0", "pe", "deg",
                             "mask", "inv_sqrt")] + [
        stats["m"], stats["se"], stats["su"], wq]


def check_colstat(ops, stats, wq, tag):
    """colstat against its plain version with wq absent and given, two runs
    bit-identical, each output's error from float64 within
    FUSED_CPU32_FACTOR of the CPU float32 route's: (max abs error, text of
    the ratios)."""
    err, texts = 0.0, []
    plain = lambda a: cs_mod.colstat_plain(*a[:12], wq=a[12])
    for w in (None, wq):
        name = f"colstat {tag} wq={'dis' if w is not None else 1}"
        with torch.inference_mode():
            got = cs_mod.colstat(**ops, **stats, wq=w)
            again = cs_mod.colstat(**ops, **stats, wq=w)
            err = max(err, *check_outputs(
                name, got, again, cs_mod.colstat_plain(**ops, **stats, wq=w),
                ("colsum", "diag"), tag))
        texts.append(cpu32_ratios(got, plain, ("colsum", "diag"),
                                  colstat_args(ops, stats, w), name))
    return err, " / ".join(texts)


def check_kernels(device, h=8, d=64, shapes=CHECK_SHAPES, dvs=(64, 8),
                  fold_shape=True, f64=False):
    """Phase 3: each kernel vs its plain version, two runs of the
    forward and of colstat bit-identical, colstat's error from float64
    within 2x the CPU float32 route's (colstat does not read vw: each dv
    gives it another draw of the inputs; with `f64` the forward's too);
    then (`fold_shape`) colstat at the `fold` step's B=1, N=2048; returns
    the JSON rows (numbers of the first shape at dvs[0], errors over all
    shapes)."""
    rows = {}
    errs = {"flash_fwd": 0.0, "colstat": 0.0}
    for b, n, pad in shapes:
        for dv in dvs:
            ops, vw = attention_inputs(b + n + dv, b, h, n, d, dv, pad,
                                       device)
            with torch.inference_mode():
                got = fl_mod.flash_fwd(vw=vw, **ops)
                again = fl_mod.flash_fwd(vw=vw, **ops)
                want = fl_mod.flash_fwd_plain(vw=vw, **ops)
                torch.cuda.synchronize()
                e1 = max(check_outputs("flash_fwd", got, again, want,
                                        ("outh", "m", "se", "su"),
                                        f"N={n} dv={dv}"))
                stats = dict(m=want[1], se=want[2], su=want[3])
                wq = torch.rand(want[2].shape, device=device,
                                generator=torch.Generator(device).manual_seed(n))
            r1 = ""
            if f64:
                r1 = ("; flash_fwd's error from float64 over the CPU float32 "
                      "route's: " + cpu32_ratios(
                          got, lambda a: fl_mod.flash_fwd_plain(*a),
                          ("outh", "m", "se", "su"),
                          [ops[k] for k in ("xa", "x", "cq", "ck", "c0")]
                          + [vw] + [ops[k] for k in ("pe", "deg", "mask",
                                                     "inv_sqrt")],
                          f"flash_fwd B={b} N={n} D={d} dv={dv}")
                      + f" (at most {FUSED_CPU32_FACTOR})")
            e2, r2 = check_colstat(ops, stats, wq, f"B={b} N={n} dv={dv}")
            with torch.inference_mode():
                torch.cuda.synchronize()
                t_k = time_ms(lambda: fl_mod.flash_fwd(vw=vw, **ops))
                t_p = time_ms(lambda: fl_mod.flash_fwd_plain(vw=vw, **ops))
                c_k = time_ms(lambda: cs_mod.colstat(**ops, **stats, wq=wq))
                c_p = time_ms(lambda: cs_mod.colstat_plain(**ops, **stats,
                                                           wq=wq))
            errs["flash_fwd"] = max(errs["flash_fwd"], e1)
            errs["colstat"] = max(errs["colstat"], e2)
            f_row, f_text = pass_bounds(
                t_k, flash_cost(ops["mask"], h, d, dv), ops["mask"], h, d)
            cb, cby = bound(*colstat_cost(ops["mask"], h, d))
            print(f"kernel check B={b} H={h} N={n} D={d} dv={dv} pad~{pad}: "
                  f"flash_fwd err {e1:.3e} {t_k:.4f} ms (plain {t_p:.4f} ms,"
                  f" {f_text}); colstat err {e2:.3e} "
                  f"{c_k:.4f} ms (plain {c_p:.4f} ms, bound {cb:.4f} ms "
                  f"{cby}); flash_fwd's and colstat's two runs "
                  f"bit-identical; tolerance rtol 1e-4 atol 1e-5; colstat's "
                  f"error from float64 over the CPU float32 route's (wq 1 / "
                  f"wq): {r2} (at most {FUSED_CPU32_FACTOR}){r1}",
                  flush=True)
            if (b, n, pad) == shapes[0] and dv == dvs[0]:
                rows["flash_fwd"] = dict(ms=t_k, plain_ms=t_p, **f_row)
                rows["colstat"] = dict(ms=c_k, plain_ms=c_p, bound_ms=cb,
                                       bound_by=cby)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    if not fold_shape:
        return rows
    b, n, pad = HF_SHAPES[0]
    ops, vw = attention_inputs(b + n, b, h, n, d, 8, pad, device)
    with torch.inference_mode():
        _, m, se, su = fl_mod.flash_fwd_plain(vw=vw, **ops)
    stats = dict(m=m, se=se, su=su)
    wq = torch.rand(se.shape, device=device,
                    generator=torch.Generator(device).manual_seed(n))
    e2, r2 = check_colstat(ops, stats, wq, f"B={b} N={n}")
    errs["colstat"] = max(errs["colstat"], e2)
    with torch.inference_mode():
        c_k = time_ms(lambda: cs_mod.colstat(**ops, **stats, wq=wq))
        c_p = time_ms(lambda: cs_mod.colstat_plain(**ops, **stats, wq=wq))
    cb, cby = bound(*colstat_cost(ops["mask"], h, d))
    print(f"colstat check B={b} H={h} N={n} D={d} pad~{pad} (the fold "
          f"step's shape): err {e2:.3e} {c_k:.4f} ms (plain {c_p:.4f} ms, "
          f"bound {cb:.4f} ms {cby}); two runs bit-identical; tolerance rtol "
          f"1e-4 atol 1e-5; error from float64 over the CPU float32 "
          f"route's (wq 1 / wq): {r2} (at most {FUSED_CPU32_FACTOR})",
          flush=True)
    rows["colstat"]["max_abs_err"] = errs["colstat"]
    return rows


def bwd_cost(mask, h, d, dv, which, vb=4, mb=4):
    """(flops, bytes) of one backward pass on these inputs, counted from
    the mask as `flash_cost`: the products of each real pair; the real rows
    of each input (the forward's operands, g and five row constants) and
    the real pairs of pe read once, each output written once (q: dxa, dcq;
    k: dvw, dck, dx); vb, mb as in `flash_cost` (g and the gradients of
    the values take vb, dcq and dck 4)."""
    b, n, rows, pairs = real_counts(mask)
    values = h * rows * d + rows * d + 2 * h * rows * dv
    f32 = 2 * h * rows + h + b * n + 5 * h * rows
    if which == "q":
        return (2.0 * h * pairs * (2 * d + dv),
                vb * (values + b * h * n * d) + mb * (pairs + rows)
                + 4.0 * (f32 + b * h * n))
    return (2.0 * h * pairs * (2 * d + 2 * dv),
            vb * (values + b * h * n * dv + b * n * d) + mb * (pairs + rows)
            + 4.0 * (f32 + b * h * n))


def bwd_inputs(seed, b, h, n, d, dv, pad, device, guard_rows=8):
    """Backward operands: the attention inputs with pe zero on the first
    `guard_rows` (real) query rows of graph 0, so su = 0 there and those
    rows take the |su/se| <= 1e-9 branch (beta = 0; c = r = 0 as outh = 0);
    the forward statistics from the plain version; a random cotangent; su
    zeroed on `guard_rows` further real rows (of graph 1; with one graph,
    graph 0's next rows), so the branch also runs with c = r != 0; and the
    row constants."""
    ops, vw = attention_inputs(seed, b, h, n, d, dv, pad, device)
    ops["pe"][0, :guard_rows] = 0.0
    outh, m, se, su = fl_mod.flash_fwd_plain(vw=vw, **ops)
    g = torch.randn(outh.shape, device=device,
                    generator=torch.Generator(device).manual_seed(seed))
    first = guard_rows if b == 1 else 0
    su[min(b - 1, 1), :, first:first + guard_rows] = 0.0
    consts = bwd_row_constants(g, outh, se, su, ops["mask"])
    n_guard = int(((su / se).abs() <= 1e-9).logical_and(
        ops["mask"][:, None] > 0).sum())
    args = (ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"], vw,
            ops["pe"], ops["deg"], ops["mask"], ops["inv_sqrt"], g, m,
            *consts)
    return args, n_guard, int((consts[3] != 0).sum())


def check_bwd_kernels(device, h=8, d=64, shapes=CHECK_SHAPES, dvs=(64, 8),
                      f64=False):
    """Phase 3, backward: flash_bwd_q / flash_bwd_k vs their plain
    versions, two runs of each bit-identical; with `f64`, each output's
    error from float64 within 2x the CPU float32 route's; returns the JSON
    rows like `check_kernels`."""
    rows = {}
    errs = {"flash_bwd_q": 0.0, "flash_bwd_k": 0.0}
    passes = {"flash_bwd_q": (fl_mod.flash_bwd_q, fl_mod.flash_bwd_q_plain),
              "flash_bwd_k": (fl_mod.flash_bwd_k, fl_mod.flash_bwd_k_plain)}
    for b, n, pad in shapes:
        for dv in dvs:
            args, n_guard, n_c = bwd_inputs(b + n + dv + 1, b, h, n, d, dv,
                                            pad, device)
            mask = args[8]
            line = [f"backward check B={b} H={h} N={n} D={d} dv={dv} "
                    f"pad~{pad}: {n_guard} rows in the guard branch, {n_c} "
                    f"with c != 0"]
            with torch.inference_mode():
                for name, (kernel, plain) in passes.items():
                    got, again = kernel(*args), kernel(*args)
                    want = plain(*args)
                    torch.cuda.synchronize()
                    outs = ("dxa", "dcq") if name.endswith("q") else (
                        "dvw", "dck", "dx")
                    each = check_outputs(name, got, again, want, outs,
                                         f"N={n} dv={dv}")
                    errs[name] = max(errs[name], *each)
                    t_k = time_ms(lambda: kernel(*args))
                    t_p = time_ms(lambda: plain(*args))
                    row, text = pass_bounds(
                        t_k, bwd_cost(mask, h, d, dv, name[-1]), mask, h, d)
                    if f64:
                        text += ("; error from float64 over the CPU float32 "
                                 "route's: " + cpu32_ratios(
                                     got, lambda a, p=plain: p(*a), outs,
                                     list(args), f"{name} B={b} N={n} D={d} "
                                     f"dv={dv}")
                                 + f" (at most {FUSED_CPU32_FACTOR})")
                    line.append(
                        f"{name} err " + " ".join(
                            f"{o} {e:.3e}" for o, e in zip(outs, each))
                        + f"; {t_k:.4f} ms (plain {t_p:.4f} ms, {text})")
                    if (b, n, pad) == shapes[0] and dv == dvs[0]:
                        rows[name] = dict(ms=t_k, plain_ms=t_p, **row)
            print("; ".join(line) + "; two runs of each bit-identical; "
                  "tolerance rtol 1e-4 atol 1e-5", flush=True)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    return rows


def check_hf_kernels(device, h=8, d=64, shapes=HF_SHAPES):
    """Phase 3, head-folded kernels: each against its plain version (the
    unfolded kernel's: the same function) and against its unfolded CUDA
    twin, bit for bit where it runs the twin's body (`BIT_EQUAL_TWINS`),
    on the backward's guard-row operands; two runs of each bit-identical.
    Returns the JSON rows (the first shape at dv=64)."""
    rows = {}
    errs = dict.fromkeys(("flash_fwd_hf", "flash_bwd_q_hf", "flash_bwd_k_hf"),
                         0.0)
    for b, n, pad in shapes:
        for dv in (64, 8):
            args, n_guard, n_c = bwd_inputs(b + n + dv + 2, b, h, n, d, dv,
                                            pad, device)
            mask = args[8]
            passes = (
                ("flash_fwd_hf", fl_mod.flash_fwd, fl_mod.flash_fwd_plain,
                 args[:10], ("outh", "m", "se", "su"),
                 flash_cost(mask, h, d, dv)),
                ("flash_bwd_q_hf", fl_mod.flash_bwd_q,
                 fl_mod.flash_bwd_q_plain, args, ("dxa", "dcq"),
                 bwd_cost(mask, h, d, dv, "q")),
                ("flash_bwd_k_hf", fl_mod.flash_bwd_k,
                 fl_mod.flash_bwd_k_plain, args, ("dvw", "dck", "dx"),
                 bwd_cost(mask, h, d, dv, "k")))
            line = [f"folded check B={b} H={h} N={n} D={d} dv={dv} "
                    f"pad~{pad}: {n_guard} rows in the guard branch, {n_c} "
                    f"with c != 0"]
            for name, twin, plain, a, outs, cost in passes:
                kernel = getattr(fl_mod, name)
                tag = f"B={b} N={n} dv={dv}"
                with torch.inference_mode():
                    got, again, unf = kernel(*a), kernel(*a), twin(*a)
                    want = plain(*a)
                    torch.cuda.synchronize()
                    each = check_outputs(name, got, again, want, outs, tag)
                    e_twin = max_err(got, unf, f"{name} against the unfolded "
                                     f"kernel {tag}")
                    if name in BIT_EQUAL_TWINS and not all(
                            map(torch.equal, got, unf)):
                        raise AssertionError(f"{name} {tag}: not bit-equal "
                                             f"to the unfolded kernel")
                    t_k, t_u, t_p = (time_ms(lambda f=f: f(*a))
                                     for f in (kernel, twin, plain))
                errs[name] = max(errs[name], *each)
                row, text = pass_bounds(t_k, cost, mask, h, d)
                line.append(
                    f"{name} err " + " ".join(
                        f"{o} {e:.3e}" for o, e in zip(outs, each))
                    + f" (against the unfolded kernel {e_twin:.3e}); "
                    f"{t_k:.4f} ms (unfolded {t_u:.4f} ms, folded/unfolded "
                    f"{t_k / t_u:.2f}, plain {t_p:.4f} ms, {text})")
                if (b, n, pad) == shapes[0] and dv == 64:
                    rows[name] = dict(ms=t_k, plain_ms=t_p, **row)
            print("; ".join(line) + "; two runs of each bit-identical; "
                  "tolerance rtol 1e-4 atol 1e-5", flush=True)
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


def mlp_g_scale(r):
    """The cotangent scale `check_fused_mlp` gives R rows: mlp_inputs'
    0.005 up to the SAN head's 40,960 rows, beyond them the same budget
    spread over R (0.005 * 40,960 / R). dW2 = h^T g sums R terms, and
    float32 rounding of such a sum grows with R and |g| on both sides: at
    the edge eigen-PE head's 462,080 rows and g ~ 0.005 the kernel's dW2
    and cuBLAS's (the plain version) differed by 3.1e-5, past atol 1e-5
    on entries near zero (the check prints each output's float64 error,
    the kernel's beside the plain version's). A pair row's cotangent is
    smaller than a node row's anyway: each pair feeds one edge of the
    attention, about a node row's / N."""
    return 0.005 * min(1.0, SAN_ROWS / r)


def mlp_cost(r, din, f, dout, which, vb=4):
    """(flops, bytes) of one call: the forward's two products, or the
    backward's five (g W2^T, dx, dW1, dW2 and the recomputed x W1); each
    input read once, each output written once. vb: bytes of an element of
    x, w1, w2, g, y and dx (2 under the bf16 policy; the biases and the
    weight gradients stay float32)."""
    mats = din * f + f * dout
    if which == "fwd":
        return (2.0 * r * f * (din + dout),
                vb * (r * din + mats + r * dout) + 4.0 * (f + dout))
    return (2.0 * r * f * (3 * din + 2 * dout),
            vb * (r * din + mats + r * dout + r * din)
            + 4.0 * (mats + 2 * f + dout))


def mlp_bounds(r, din, f, dout, rate, which):
    """A fused-MLP kernel's two bounds, (JSON fields, text): all of its
    products as f32 FMAs on the CUDA cores (`bound`), and the bound of
    what it issues, its `bound_ms`, the pipes side by side: its products
    in 3xTF32 at the TF32 peak; the keep bit's HASH_IMAD_OPS multiplies
    and HASH_ALU_OPS (the forward's: FWD_HASH_ALU_OPS) other instructions
    per (row, unit) at the INT32 rate (the hash only at rate > 0); the
    dispatch of the products' HMMAs and
    the keep bit's instructions, a warp instruction a clock per SM
    sub-partition; or its bytes."""
    flops, nbytes = mlp_cost(r, din, f, dout, which)
    b32, by32 = bound(flops, nbytes)
    hashes = r * f if rate > 0 else 0
    t_tc = TF32_SPLIT * flops / PEAK_TF32_FLOPS
    alu = FWD_HASH_ALU_OPS if which == "fwd" else HASH_ALU_OPS
    t_imad = HASH_IMAD_OPS * hashes / PEAK_INT32_OPS
    t_alu = alu * hashes / PEAK_INT32_OPS
    t_issue = (TF32_SPLIT * flops / MMA_FLOPS + (
        HASH_IMAD_OPS + alu) * hashes / 32) / PEAK_WARP_ISSUE
    t_bytes = nbytes / PEAK_BYTES
    t_ops = max(t_tc, t_imad, t_alu, t_issue)
    issued = max(t_ops, t_bytes) * 1e3
    by = "bytes" if t_bytes > t_ops else "operations"
    text = (f"bound {issued:.4f} ms {by} (3xTF32 products {t_tc * 1e3:.4f},"
            f" the hash's multiplies {t_imad * 1e3:.4f}, its INT32 "
            f"instructions {t_alu * 1e3:.4f}, dispatch {t_issue * 1e3:.4f},"
            f" bytes {t_bytes * 1e3:.4f}), f32 CUDA cores only {b32:.4f} "
            f"ms {by32}")
    return dict(bound_ms=issued, bound_by=by, bound_f32_ms=b32), text


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
    versions at each shape's rates; two forward and two backward runs
    bit-identical (cotangent scale `mlp_g_scale`); each output's error
    from float64 within FUSED_CPU32_FACTOR of the CPU float32 route's;
    each kernel timed warm
    and cold (`time_ms(cold=True)`); the kernels' dropout masks bit-equal
    to the plain version's and keeping 0.9 +- 0.002 of the units. Returns
    the JSON rows like `check_kernels`, the "main" shape's at rate 0.1,
    with the forward's at rate 0 beside (`ms_rate0`, `plain_ms_rate0`,
    `bound_ms_rate0`) and each other tagged shape's at rate 0.1 (`ms_<tag>`,
    `ms_<tag>_cold`, `plain_ms_<tag>`, `bound_ms_<tag>`)."""
    rows = {}
    errs = {"fused_mlp_fwd": 0.0, "fused_mlp_bwd": 0.0}
    for r, din, f, dout, rates, tag in shapes:
        x, w1, b1, w2, b2, g = mlp_inputs(r + f, r, din, f, dout, device,
                                          g_scale=mlp_g_scale(r))
        for rate in rates:
            with torch.no_grad():
                fwd = lambda: fm_mod.fused_mlp_fwd(x, w1, b1, w2, b2, rate,
                                                   seed)
                bwd = lambda: fm_mod.fused_mlp_bwd(x, w1, b1, w2, g, rate,
                                                   seed)
                plain_f = lambda: fm_mod.fused_mlp_plain(x, w1, b1, w2, b2,
                                                         rate, seed)
                plain_b = lambda: fm_mod.fused_mlp_bwd_plain(x, w1, b1, w2,
                                                             g, rate, seed)
                got_f, again_f = fwd(), fwd()
                got_b, again = bwd(), bwd()
                torch.cuda.synchronize()
                tag_text = f"R={r} d={din} rate={rate}"
                e_f = max_err([got_f], [plain_f()],
                              f"fused_mlp_fwd {tag_text}")
                card32 = plain_b()
                e_b = max_err(got_b, card32, f"fused_mlp_bwd {tag_text}")
                if not torch.equal(got_f, again_f):
                    raise AssertionError(f"fused_mlp_fwd {tag_text}: two "
                                         "runs differ")
                if not all(torch.equal(a, b) for a, b in zip(got_b, again)):
                    raise AssertionError(f"fused_mlp_bwd {tag_text}: two "
                                         "runs differ")
                times = [time_ms(fn) for fn in (fwd, bwd, plain_f, plain_b)]
                cold = [time_ms(fn, cold=True) for fn in (fwd, bwd)]
            del again_f, again
            ratio_f = cpu32_ratios(
                [got_f], lambda a: [fm_mod.fused_mlp_plain(*a, rate, seed)],
                ("y",), [x, w1, b1, w2, b2], f"fused_mlp_fwd {tag_text}")
            ratios = cpu32_ratios(
                got_b, lambda a: fm_mod.fused_mlp_bwd_plain(*a, rate, seed),
                ("dx", "dW1", "db1", "dW2", "db2"), [x, w1, b1, w2, g],
                f"fused_mlp_bwd {tag_text}", card32=card32)
            del got_f, got_b, card32
            errs["fused_mlp_fwd"] = max(errs["fused_mlp_fwd"], e_f)
            errs["fused_mlp_bwd"] = max(errs["fused_mlp_bwd"], e_b)
            jf, tf = mlp_bounds(r, din, f, dout, rate, "fwd")
            jb, tb = mlp_bounds(r, din, f, dout, rate, "bwd")
            print(f"fused-MLP check R={r} d_in={din} F={f} d_out={dout} "
                  f"rate={rate} ({fm_mod.fwd_slabs(din, f, dout)} forward "
                  f"slab(s)): fwd err {e_f:.3e} {times[0]:.4f} ms warm, "
                  f"{cold[0]:.4f} ms cold (plain {times[2]:.4f} ms, {tf}); "
                  f"bwd err {e_b:.3e} {times[1]:.4f} ms warm, {cold[1]:.4f} "
                  f"ms cold (plain {times[3]:.4f} ms, {tb}); two fwd and two "
                  f"bwd runs bit-identical; tolerance rtol 1e-4 atol 1e-5; "
                  f"error from float64 over the CPU float32 route's: fwd "
                  f"{ratio_f}, bwd {ratios} (at most {FUSED_CPU32_FACTOR})",
                  flush=True)
            pairs = (("fused_mlp_fwd", times[0], times[2], cold[0], jf),
                     ("fused_mlp_bwd", times[1], times[3], cold[1], jb))
            if tag == "main" and rate > 0:
                for name, t_k, t_p, _, j in pairs:
                    rows.setdefault(name, {}).update(ms=t_k, plain_ms=t_p,
                                                     **j)
            elif tag == "main":
                rows.setdefault("fused_mlp_fwd", {}).update(
                    ms_rate0=times[0], plain_ms_rate0=times[2],
                    bound_ms_rate0=jf["bound_ms"])
            elif tag and rate > 0:
                for name, t_k, t_p, t_c, j in pairs:
                    rows.setdefault(name, {}).update({
                        f"ms_{tag}": t_k, f"ms_{tag}_cold": t_c,
                        f"plain_ms_{tag}": t_p,
                        f"bound_ms_{tag}": j["bound_ms"]})
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


def modulation_inputs(seed, b, h, n, pad, device, guard_rows=4):
    """Scaled scores [B, H, N, N], pe, degree and mask (graph i loses its
    last pad + (i mod 8) nodes), with pe zero on the first `guard_rows`
    query rows of graph 0 (the |denom| <= 1e-9 branch), and a cotangent."""
    ops, _ = attention_inputs(seed, b, h, n, 8 * h, 8, pad, device)
    ops["pe"][0, :guard_rows] = 0.0
    gen = torch.Generator(device).manual_seed(seed)
    scores = torch.randn((b, h, n, n), device=device, generator=gen)
    g = torch.randn((b, h, n, n), device=device, generator=gen)
    return scores, ops["pe"], ops["deg"], ops["mask"], g


def modulation_cost(mask, h, which):
    """(operations, bytes) of one call on these inputs, counted from the
    mask [B, N]: what the function needs is the score (and g) of each cell
    whose query and key are both real, read once; every output cell written
    once; pe at those cells, the degree of the real nodes and the whole
    mask, read once. ~10 operations
    per real cell forward (masked max, exp, two row sums, two divisions,
    three products) and ~20 backward (the recomputed chain, a third sum
    and the gradient)."""
    real = (mask > 0).sum(-1).double()
    b, n = mask.shape
    pairs = float((real * real).sum())
    data = pairs + float(real.sum()) + b * n
    reads = 1 if which == "fwd" else 2
    return ((10.0 if which == "fwd" else 20.0) * h * pairs,
            4.0 * (reads * h * pairs + h * b * n * n + data))


def masked_cells(mask):
    """[B, 1, N, N] True where the query or the key is masked."""
    real = mask > 0
    return ~(real[:, None, :, None] & real[:, None, None, :])


def fused_cost(mask, h, d, which, vb=4):
    """(operations, bytes), counted from the mask as `flash_cost`: the
    forward's 2 products of 2·H·D flops a real pair, the backward's 5; the
    real rows of each input and the real pairs of pe read once, each output
    written once. vb: bytes of an element of xa, x, vw, g, out, dxa, dx
    and dvw (2 under the bf16 policy; the rest stays float32)."""
    b, n, rows, pairs = real_counts(mask)
    values = 2 * h * rows * d + rows * d
    rest = 2 * h * rows + h + pairs + rows + b * n
    if which == "fwd":
        return 4.0 * h * pairs * d, vb * (values + b * n * d) + 4.0 * rest
    return (10.0 * h * pairs * d,
            vb * (values + rows * d + 2 * b * h * n * d + b * n * d)
            + 4.0 * (rest + 2 * b * h * n + b * h))


def check_outputs(name, got, again, want, outs, tag, tol=KERNEL_TOL,
                  tols=None):
    """Errors of each output of a kernel (forward or backward); raise
    unless two runs are bit-identical. `tols` maps an output's name to its
    own tolerance, in place of `tol`."""
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} {tag}: two runs differ")
    tols = tols or {}
    return [max_err([g_], [w_], f"{name} {o} {tag}", tols.get(o, tol))
            for o, g_, w_ in zip(outs, got, want)]


def check_modulation(device, h=8, shapes=MOD_SHAPES):
    """Phase 3, modulation kernels: forward and backward vs their plain
    versions, with padded nodes and guard rows; two backward runs
    bit-identical; both outputs exactly 0 at every cell with a masked query
    or key; at MOD_F64_SHAPES each output's error from float64
    within FUSED_CPU32_FACTOR of the CPU float32 route's. Times warm and
    cold (`time_ms`) beside the bound of
    `modulation_cost`. Returns the JSON rows (numbers of the first shape,
    the ZINC batch; its warm times)."""
    rows = {}
    errs = {"modulation_fwd": 0.0, "modulation_bwd": 0.0}
    for b, n, pad in shapes:
        scores, pe, deg, mask, g = modulation_inputs(b + n, b, h, n, pad,
                                                     device)
        fwd = lambda: mod_mod.modulation_fwd(scores, pe, deg, mask)
        bwd = lambda: mod_mod.modulation_bwd(scores, pe, deg, mask, g)
        plain_f = lambda: mod_mod.modulation_fwd_plain(scores, pe, deg, mask)
        plain_b = lambda: mod_mod.modulation_bwd_plain(scores, pe, deg, mask,
                                                       g)
        with torch.inference_mode():
            got_f, got_b, again = fwd(), bwd(), bwd()
            torch.cuda.synchronize()
            tag = f"B={b} N={n}"
            e_f = max_err([got_f], [plain_f()], f"modulation_fwd {tag}")
            (e_b,) = check_outputs("modulation_bwd", [got_b], [again],
                                   [plain_b()], ("ds",), tag)
            dead = masked_cells(mask).expand_as(got_f)
            for name, out in (("fwd", got_f), ("bwd", got_b)):
                if bool((out[dead] != 0).any()):
                    raise AssertionError(f"modulation_{name} {tag}: nonzero "
                                         f"output at a masked cell")
            pd = pe[0, :4] * deg[0]
            n_guard = int((pd.sum(-1) == 0).sum())
            times = [time_ms(fn) for fn in (fwd, bwd, plain_f, plain_b)]
            cold = [time_ms(fn, cold=True) for fn in (fwd, bwd)]
        ratios = ""
        if (b, n, pad) in MOD_F64_SHAPES:
            args = [scores, pe, deg, mask, g]
            r_f = cpu32_ratios([got_f], lambda a: [
                mod_mod.modulation_fwd_plain(*a[:4])], ("attn",), args,
                f"modulation_fwd {tag}")
            r_b = cpu32_ratios([got_b], lambda a: [
                mod_mod.modulation_bwd_plain(*a)], ("ds",), args,
                f"modulation_bwd {tag}")
            ratios = (f"; error from float64 over the CPU float32 route's: "
                      f"{r_f} {r_b} (at most {FUSED_CPU32_FACTOR})")
        errs["modulation_fwd"] = max(errs["modulation_fwd"], e_f)
        errs["modulation_bwd"] = max(errs["modulation_bwd"], e_b)
        bf = bound(*modulation_cost(mask, h, "fwd"))
        bb = bound(*modulation_cost(mask, h, "bwd"))
        print(f"modulation check B={b} H={h} N={n} pad~{pad} ({n_guard} "
              f"guard rows x {h} heads; team T, V = "
              f"{mod_mod.team_geometry(n)}): fwd err "
              f"{e_f:.3e} {times[0]:.4f} ms, cold {cold[0]:.4f} ms (plain "
              f"{times[2]:.4f} ms, bound {bf[0]:.4f} ms {bf[1]}, "
              f"{100 * bf[0] / cold[0]:.1f} % cold); bwd err {e_b:.3e} "
              f"{times[1]:.4f} ms, cold {cold[1]:.4f} ms (plain "
              f"{times[3]:.4f} ms, bound {bb[0]:.4f} ms {bb[1]}, "
              f"{100 * bb[0] / cold[1]:.1f} % cold); two bwd runs "
              f"bit-identical; 0 at every masked cell; tolerance rtol 1e-4 "
              f"atol 1e-5{ratios}", flush=True)
        if (b, n, pad) == shapes[0]:
            for name, t_k, t_p, (b_ms, by) in (
                    ("modulation_fwd", times[0], times[2], bf),
                    ("modulation_bwd", times[1], times[3], bb)):
                rows[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                                  bound_by=by)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    return rows


def fused_inputs(seed, b, h, n, d, pad, device):
    """The fused kernels' operands: `attention_inputs`' with pe zero on
    graph 0's first 4 query rows (the |denom| <= 1e-9 branch), vw, and a
    cotangent g [B, N, D]."""
    ops, vw = attention_inputs(seed, b, h, n, d, d, pad, device)
    ops["pe"][0, :4] = 0.0                          # guard rows
    g = 0.1 * torch.randn((b, n, d), device=device,
                          generator=torch.Generator(device).manual_seed(n))
    return ops, vw, g


def cpu32_ratios(got, plain, outs, args, tag, card32=None,
                 cpu_dtype=torch.float32, factor=FUSED_CPU32_FACTOR):
    """Each of the kernel's outputs `got`: its max abs error against a
    float64 run of the plain version over the CPU float32 route's (the
    plain version in float32 on the CPU) on the same inputs; raise above
    `factor`. `plain` maps the operands `args` (the card's) to
    the list of outputs. With `card32`, the plain version's float32
    outputs on the card, the text adds each output's float64 error, the
    kernel's beside that route's. `cpu_dtype` None: the CPU route takes
    the operands in their own dtypes (the plain bf16 route)."""
    on = lambda dev, dt: [(t.to(dev, dt) if dt else t.to(dev))
                          if torch.is_tensor(t) else t for t in args]
    with torch.inference_mode():
        want = [w.cpu() for w in plain(on(args[0].device, torch.float64))]
        cpu = plain(on("cpu", cpu_dtype))
    ratios = []
    gap = lambda a, w: float((a.cpu().double() - w).abs().max())
    for o, k, c, w in zip(outs, got, cpu, want):
        e_k, e_c = gap(k, w), gap(c, w)
        ratios.append(e_k / e_c if e_c > 0 else (0.0 if e_k == 0 else
                                                 float("inf")))
    text = " ".join(f"{o} {r:.2f}" for o, r in zip(outs, ratios))
    if card32 is not None:
        text += "; float64 error, kernel / the plain version on the card: " \
            + " ".join(f"{o} {gap(k, w):.2e} / {gap(p, w):.2e}"
                       for o, k, p, w in zip(outs, got, card32, want))
    if max(ratios) > factor:
        route = "float32" if cpu_dtype else "plain bf16"
        raise AssertionError(f"{tag}: an output's error from float64 is "
                             f"above {factor}x the CPU {route} route's "
                             f"({text})")
    return text


def check_fused_attention(device, h=8, d=64, shapes=FUSED_SHAPES):
    """Phase 3, fused attention kernels: forward and backward vs their plain
    versions, with padded nodes and guard rows; two backward runs
    bit-identical; each output's error from float64 within
    FUSED_CPU32_FACTOR of the CPU float32 route's. Returns the JSON rows
    (the ZINC batch's)."""
    rows = {}
    errs = {"fused_attn_fwd": 0.0, "fused_attn_bwd": 0.0}
    outs = ("dxa", "dx", "dcq", "dck", "dc0", "dvw")
    for b, n, pad in shapes:
        ops, vw, g = fused_inputs(b + n + 3, b, h, n, d, pad, device)
        fwd = lambda: fa_mod.fused_attn_fwd(vw=vw, **ops)
        bwd = lambda: fa_mod.fused_attn_bwd(vw=vw, g=g, **ops)
        plain_f = lambda: fa_mod.fused_attn_fwd_plain(vw=vw, **ops)
        plain_b = lambda: fa_mod.fused_attn_bwd_plain(vw=vw, g=g, **ops)
        args = [ops[k] for k in ("xa", "x", "cq", "ck", "c0")] + [vw] + [
            ops[k] for k in ("pe", "deg", "mask", "inv_sqrt")] + [g]
        with torch.inference_mode():
            got_f, got_b, again = fwd(), bwd(), bwd()
            torch.cuda.synchronize()
            tag = f"B={b} N={n}"
            e_f = max_err([got_f], [plain_f()], f"fused_attn_fwd {tag}")
            each = check_outputs("fused_attn_bwd", got_b, again, plain_b(),
                                 outs, tag)
            times = [time_ms(fn) for fn in (fwd, bwd, plain_f, plain_b)]
        r_f = cpu32_ratios([got_f],
                           lambda a: [fa_mod.fused_attn_fwd_plain(*a[:-1])],
                           ("out",), args, f"fused_attn_fwd {tag}")
        r_b = cpu32_ratios(got_b, lambda a: fa_mod.fused_attn_bwd_plain(*a),
                           outs, args, f"fused_attn_bwd {tag}")
        errs["fused_attn_fwd"] = max(errs["fused_attn_fwd"], e_f)
        errs["fused_attn_bwd"] = max(errs["fused_attn_bwd"], *each)
        mask = ops["mask"]
        jf, tf = pass_bounds(times[0], fused_cost(mask, h, d, "fwd"), mask,
                             h, d)
        jb, tb = pass_bounds(times[1], fused_cost(mask, h, d, "bwd"), mask,
                             h, d)
        print(f"fused-attention check B={b} H={h} N={n} D={d} pad~{pad} "
              f"(clusters of {fa_mod.cluster_size(h)} CTAs): fwd err "
              f"{e_f:.3e} {times[0]:.4f} ms (plain {times[2]:.4f} ms; {tf}); "
              f"bwd err " + " ".join(f"{o} {e:.3e}" for o, e in
                                     zip(outs, each))
              + f"; {times[1]:.4f} ms (plain {times[3]:.4f} ms; {tb}); "
              f"two bwd runs bit-identical; tolerance rtol 1e-4 atol 1e-5; "
              f"error from float64 over the CPU float32 route's: {r_f} "
              f"{r_b} (at most {FUSED_CPU32_FACTOR})", flush=True)
        if (b, n, pad) == shapes[0]:
            for name, t_k, t_p, j in (
                    ("fused_attn_fwd", times[0], times[2], jf),
                    ("fused_attn_bwd", times[1], times[3], jb)):
                rows[name] = dict(ms=t_k, plain_ms=t_p, **j)
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    return rows


def check_unmodulated(device, h=8, d=64, shape=(ZINC_GRAPHS, ZINC_NODES,
                                                  11)):
    """Phase 3, the operands' absent case: the flash forward and both
    backward passes (#1, #3, #4) and the fused pair (#10, #11) with
    pe=None and deg=None (the vanilla GraphTransformer's attention) at the
    ZINC batch, against their plain versions (ones in place of pe and
    deg), two runs of each bit-identical, each fused output's error from
    float64 within FUSED_CPU32_FACTOR of the CPU float32 route's; returns
    each kernel's largest absolute error."""
    b, n, pad = shape
    ops, vw = attention_inputs(b + n + 5, b, h, n, d, d, pad, device)
    ops.update(pe=None, deg=None)
    errs, line = {}, []
    with torch.inference_mode():
        got, again = (fl_mod.flash_fwd(vw=vw, **ops) for _ in range(2))
        want = fl_mod.flash_fwd_plain(vw=vw, **ops)
        errs["flash_fwd"] = max(check_outputs(
            "flash_fwd", got, again, want, ("outh", "m", "se", "su"),
            "pe/deg absent"))
        outh, m, se, su = want
        g = torch.randn(outh.shape, device=device,
                        generator=torch.Generator(device).manual_seed(n))
        args = (ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"], vw,
                None, None, ops["mask"], ops["inv_sqrt"], g, m,
                *bwd_row_constants(g, outh, se, su, ops["mask"]))
        for name, kernel, plain, outs in (
                ("flash_bwd_q", fl_mod.flash_bwd_q, fl_mod.flash_bwd_q_plain,
                 ("dxa", "dcq")),
                ("flash_bwd_k", fl_mod.flash_bwd_k, fl_mod.flash_bwd_k_plain,
                 ("dvw", "dck", "dx"))):
            errs[name] = max(check_outputs(
                name, kernel(*args), kernel(*args), plain(*args), outs,
                "pe/deg absent"))
        gf = 0.1 * torch.randn((b, n, d), device=device,
                               generator=torch.Generator(device).manual_seed(
                                   n + 1))
        f_got = fa_mod.fused_attn_fwd(vw=vw, **ops)
        f_again = fa_mod.fused_attn_fwd(vw=vw, **ops)
        errs["fused_attn_fwd"] = max(check_outputs(
            "fused_attn_fwd", [f_got], [f_again],
            [fa_mod.fused_attn_fwd_plain(vw=vw, **ops)], ("out",),
            "pe/deg absent"))
        b_outs = ("dxa", "dx", "dcq", "dck", "dc0", "dvw")
        b_got = fa_mod.fused_attn_bwd(vw=vw, g=gf, **ops)
        errs["fused_attn_bwd"] = max(check_outputs(
            "fused_attn_bwd", b_got, fa_mod.fused_attn_bwd(vw=vw, g=gf, **ops),
            fa_mod.fused_attn_bwd_plain(vw=vw, g=gf, **ops), b_outs,
            "pe/deg absent"))
        times = {name: time_ms(fn) for name, fn in (
            ("flash_fwd", lambda: fl_mod.flash_fwd(vw=vw, **ops)),
            ("flash_bwd_q", lambda: fl_mod.flash_bwd_q(*args)),
            ("flash_bwd_k", lambda: fl_mod.flash_bwd_k(*args)),
            ("fused_attn_fwd", lambda: fa_mod.fused_attn_fwd(vw=vw, **ops)),
            ("fused_attn_bwd",
             lambda: fa_mod.fused_attn_bwd(vw=vw, g=gf, **ops)))}
    f_args = [ops[k] for k in ("xa", "x", "cq", "ck", "c0")] + [vw] + [
        None, None, ops["mask"], ops["inv_sqrt"], gf]
    r_f = cpu32_ratios([f_got],
                       lambda a: [fa_mod.fused_attn_fwd_plain(*a[:-1])],
                       ("out",), f_args, "fused_attn_fwd pe/deg absent")
    r_b = cpu32_ratios(b_got, lambda a: fa_mod.fused_attn_bwd_plain(*a),
                       b_outs, f_args, "fused_attn_bwd pe/deg absent")
    print(f"unmodulated check B={b} H={h} N={n} D={d} pad~{pad}, pe and deg "
          f"absent (nullptr): max abs err " + ", ".join(
              f"{k} {v:.3e} ({times[k]:.4f} ms)" for k, v in errs.items())
          + f"; two runs of each bit-identical; tolerance rtol 1e-4 atol "
          f"1e-5; fused error from float64 over the CPU float32 route's: "
          f"{r_f} {r_b} (at most {FUSED_CPU32_FACTOR})", flush=True)
    return errs


def bf16_operands(ops, vw, mdt):
    """The kernels' operands under the bf16 compute policy: xa, x and vw
    in bf16, pe and deg in `mdt` (bf16, FETA_BF16_MODULATION=1, or float32,
    =0), the masks, cq, ck and c0 float32 (`fl_mod.prepare`)."""
    out = dict(ops, xa=ops["xa"].to(torch.bfloat16),
               x=ops["x"].to(torch.bfloat16))
    for k in ("pe", "deg"):
        out[k] = None if ops[k] is None else ops[k].to(mdt)
    return out, vw.to(torch.bfloat16)


def bf16_bwd_args(seed, b, h, n, d, dv, pad, mdt, device, guard_rows=8):
    """`bwd_inputs` under the bf16 compute policy: bf16 xa, x, vw and
    cotangent g, pe and deg in `mdt`, the forward statistics from the plain
    bf16 forward, su zeroed on guard rows as there, and the row
    constants."""
    ops, vw = attention_inputs(seed, b, h, n, d, dv, pad, device)
    ops["pe"][0, :guard_rows] = 0.0
    ops, vw = bf16_operands(ops, vw, mdt)
    outh, m, se, su = fl_mod.flash_fwd_plain(vw=vw, **ops)
    g = torch.randn(outh.shape, device=device,
                    generator=torch.Generator(device).manual_seed(seed)
                    ).to(torch.bfloat16)
    first = guard_rows if b == 1 else 0
    su[min(b - 1, 1), :, first:first + guard_rows] = 0.0
    consts = bwd_row_constants(g, outh, se, su, ops["mask"])
    return ops, vw, (ops["xa"], ops["x"], ops["cq"], ops["ck"], ops["c0"],
                     vw, ops["pe"], ops["deg"], ops["mask"], ops["inv_sqrt"],
                     g, m, *consts)


def bf16_bound(cost):
    """(ms, what bounds it) of a bf16 kernel's (flops, bytes): its
    products at the bf16 tensor-core peak, its bytes (bf16 operands at 2
    bytes) at the memory rate."""
    t_ops, t_bytes = cost[0] / PEAK_BF16_FLOPS, cost[1] / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bf16_outh_tol(vw):
    """The tolerance of a bf16 forward's outh against the plain version
    (BF16_KERNEL_TOL's note)."""
    return dict(rtol=BF16_KERNEL_TOL["rtol"],
                atol=2.0 ** -8 * float(vw.float().abs().max()))


def check_bf16_kernels(device, h=8, shapes=BF16_SHAPES, checks=BF16_CHECKS):
    """The bf16 phase's kernel checks: the unfolded flash forward (#1), colstat
    (#2, wq 1 and random) and both backward passes (#3, #4) with bf16 operands
    at each (B, N, padding) of `shapes`, for each (D, value widths) of `checks`
    (the first only past the first shape) and pe/deg in bf16 and in float32:
    each against its plain bf16 version on the card (BF16_KERNEL_TOL; colstat,
    whose arithmetic after the staging is float32, at KERNEL_TOL), two runs
    bit-identical, outputs in the JAX kernels' dtypes (outh at
    `bf16_outh_tol`); on the first and the last shape, at the (D, dv, pe dtype)
    of BF16_F64, each output's error from a float64 run of the plain version
    within BF16_CPU_FACTOR of the CPU plain bf16 route's; on the first, the
    timed combinations (BF16_TIMED) beside their float32 kernels on the same
    values. Returns each kernel's row fields (`ms_bf16`, `plain_ms_bf16`,
    `bound_ms_bf16`, `bound_by_bf16`, `ms_f32_twin`, `max_abs_err_bf16`:
    numbers of the first shape at D=64, dv=64, pe bf16; errors over every
    combination)."""
    bf = torch.bfloat16
    rows, errs = {}, dict.fromkeys(FLASH_ROUTE, 0.0)
    combos = [(shape, d, dv, mdt) for shape in shapes
              for d, dvs in (checks if shape == shapes[0] else checks[:1])
              for dv in dvs for mdt in (bf, torch.float32)]
    for (b, n, pad), d, dv, mdt in combos:
        mb = 2 if mdt == bf else 4
        first = (b, n, pad) == shapes[0]
        f64 = (d, dv, mdt) in BF16_F64 and (first
                                            or (b, n, pad) == shapes[-1])
        timed = first and (d, dv, mdt) in BF16_TIMED
        tag = (f"bf16 B={b} N={n} D={d} dv={dv} pe/deg "
               f"{str(mdt).replace('torch.', '')}")
        ops, vw, bargs = bf16_bwd_args(b + n + d + dv, b, h, n, d, dv, pad,
                                       mdt, device)
        stats = dict(zip(("m", "se", "su"),
                         fl_mod.flash_fwd_plain(vw=vw, **ops)[1:]))
        wq = torch.rand(stats["se"].shape, device=device,
                        generator=torch.Generator(device).manual_seed(n))
        runs = {
            "flash_fwd": (lambda: fl_mod.flash_fwd(vw=vw, **ops),
                          lambda: fl_mod.flash_fwd_plain(vw=vw, **ops),
                          ("outh", "m", "se", "su"), BF16_KERNEL_TOL,
                          {"outh": bf16_outh_tol(vw)}),
            "colstat": (lambda: cs_mod.colstat(**ops, **stats, wq=wq),
                        lambda: cs_mod.colstat_plain(**ops, **stats, wq=wq),
                        ("colsum", "diag"), KERNEL_TOL, None),
            "flash_bwd_q": (lambda: fl_mod.flash_bwd_q(*bargs),
                            lambda: fl_mod.flash_bwd_q_plain(*bargs),
                            ("dxa", "dcq"), BF16_KERNEL_TOL, None),
            "flash_bwd_k": (lambda: fl_mod.flash_bwd_k(*bargs),
                            lambda: fl_mod.flash_bwd_k_plain(*bargs),
                            ("dvw", "dck", "dx"), BF16_KERNEL_TOL, None)}
        line = [f"{tag}:"]
        for name, (kernel, plain, outs, tol, tols) in runs.items():
            with torch.inference_mode():
                got, again, want = kernel(), kernel(), plain()
                torch.cuda.synchronize()
            each = check_outputs(name, got, again, want, outs, tag, tol,
                                 tols)
            errs[name] = max(errs[name], *each)
            text = f"{name} err " + " ".join(
                f"{o} {e:.3e}" for o, e in zip(outs, each))
            if f64:
                cargs = (list(bargs) if name.startswith("flash_bwd")
                         else colstat_args(ops, stats, wq)
                         if name == "colstat" else
                         [ops[k] for k in ("xa", "x", "cq", "ck",
                                           "c0")] + [vw]
                         + [ops[k] for k in ("pe", "deg", "mask",
                                             "inv_sqrt")])
                fn = {"flash_fwd": fl_mod.flash_fwd_plain,
                      "colstat": lambda *a: cs_mod.colstat_plain(
                          *a[:12], wq=a[12]),
                      "flash_bwd_q": fl_mod.flash_bwd_q_plain,
                      "flash_bwd_k": fl_mod.flash_bwd_k_plain}[name]
                text += ("; error from float64 over the CPU plain "
                         "bf16 route's: " + cpu32_ratios(
                             got, lambda a, f=fn: f(*a), outs, cargs,
                             f"{name} {tag}", cpu_dtype=None,
                             factor=BF16_CPU_FACTOR))
            if timed:
                with torch.inference_mode():
                    t_k, t_p = time_ms(kernel), time_ms(plain)
                cost = {"flash_fwd": flash_cost(ops["mask"], h, d, dv,
                                                2, mb),
                        "colstat": colstat_cost(ops["mask"], h, d, 2,
                                                mb),
                        "flash_bwd_q": bwd_cost(ops["mask"], h, d, dv,
                                                "q", 2, mb),
                        "flash_bwd_k": bwd_cost(ops["mask"], h, d, dv,
                                                "k", 2, mb)}[name]
                bms, bby = bf16_bound(cost)
                text += (f"; {t_k:.4f} ms (plain {t_p:.4f} ms, bound "
                         f"{bms:.4f} ms {bby}, {100 * bms / t_k:.2f} "
                         f"%)")
                if (d, dv, mdt) == BF16_TIMED[0]:
                    # the float32 kernel on the same values
                    up = lambda t: (t.float() if torch.is_tensor(t)
                                    else t)
                    o32 = {k: up(v) for k, v in ops.items()}
                    twin = {"flash_fwd": lambda: fl_mod.flash_fwd(
                                vw=vw.float(), **o32),
                            "colstat": lambda: cs_mod.colstat(
                                **o32, **stats, wq=wq),
                            "flash_bwd_q": lambda: fl_mod.flash_bwd_q(
                                *map(up, bargs)),
                            "flash_bwd_k": lambda: fl_mod.flash_bwd_k(
                                *map(up, bargs))}[name]
                    with torch.inference_mode():
                        t_32 = time_ms(twin)
                    text += f"; float32 kernel {t_32:.4f} ms"
                    rows[name] = dict(ms_bf16=t_k, plain_ms_bf16=t_p,
                                      bound_ms_bf16=bms,
                                      bound_by_bf16=bby,
                                      ms_f32_twin=t_32)
            line.append(text)
        print("; ".join(line) + "; two runs of each bit-identical; "
              f"tolerance {BF16_KERNEL_TOL} (outh atol "
              f"{bf16_outh_tol(vw)['atol']:.3e}; colstat {KERNEL_TOL})",
              flush=True)
    for name in rows:
        rows[name]["max_abs_err_bf16"] = errs[name]
    return rows


def bf16_fused_operands(ops, vw, g):
    """The fused pair's operands under the bf16 compute policy: xa, x, vw
    and g in bf16, pe, deg, the masks, cq, ck and c0 float32 (the JAX
    wrapper's casts)."""
    bf = torch.bfloat16
    return (dict(ops, xa=ops["xa"].to(bf), x=ops["x"].to(bf)), vw.to(bf),
            g.to(bf))


def bf16_twin(name, kernel, plain, twin, outs, tag, tols=None):
    """One bf16 kernel of #10-#13 on the card: two runs bit-identical and
    each output in its plain bf16 version's dtype and within
    BF16_KERNEL_TOL of it (or `tols`' tolerance for an output); its time,
    its plain version's and the float32 kernel's on the same values
    (`twin`). Returns (errors, (ms, plain ms, float32 twin ms))."""
    with torch.inference_mode():
        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        each = check_outputs(name, got, again, want, outs, tag,
                             BF16_KERNEL_TOL, tols)
        times = tuple(time_ms(fn) for fn in (kernel, plain, twin))
    return each, times


def check_bf16_fused(device, h=8, d=64, shapes=FUSED_SHAPES):
    """The bf16 phase's checks of the fused pair (#10, #11) with bf16 xa,
    x, vw and g at each (B, N, padding) of `shapes` (the ZINC batch and
    B=32, N=128; guard rows in graph 0): each against its plain bf16
    version on the card (`bf16_twin`: BF16_KERNEL_TOL; dcq, dck and dc0,
    float32 sums of unrounded ds, at KERNEL_TOL), two runs bit-identical,
    timed beside the float32 kernel on the same values and the bf16 bound
    (`bf16_bound`: the products at the bf16 tensor-core peak, bf16 values
    at 2 bytes); on the first shape each output's error from float64
    within BF16_CPU_FACTOR of the CPU plain bf16 route's. Returns each
    kernel's row fields (as `check_bf16_kernels`', of the first shape)."""
    rows, errs = {}, {"fused_attn_fwd": 0.0, "fused_attn_bwd": 0.0}
    outs = ("dxa", "dx", "dcq", "dck", "dc0", "dvw")
    f32_outs = dict.fromkeys(("dcq", "dck", "dc0"), KERNEL_TOL)
    for b, n, pad in shapes:
        ops32, vw32, g32 = fused_inputs(b + n + 5, b, h, n, d, pad, device)
        ops, vw, g = bf16_fused_operands(ops32, vw32, g32)
        # the float32 twin on the same (bf16-valued) operands
        o32 = {k: (v.float() if torch.is_tensor(v) else v)
               for k, v in ops.items()}
        tag = f"bf16 B={b} N={n}"
        e_f, t_f = bf16_twin(
            "fused_attn_fwd",
            lambda: [fa_mod.fused_attn_fwd(vw=vw, **ops)],
            lambda: [fa_mod.fused_attn_fwd_plain(vw=vw, **ops)],
            lambda: fa_mod.fused_attn_fwd(vw=vw.float(), **o32), ("out",),
            tag)
        e_b, t_b = bf16_twin(
            "fused_attn_bwd", lambda: fa_mod.fused_attn_bwd(vw=vw, g=g, **ops),
            lambda: fa_mod.fused_attn_bwd_plain(vw=vw, g=g, **ops),
            lambda: fa_mod.fused_attn_bwd(vw=vw.float(), g=g.float(), **o32),
            outs, tag, f32_outs)
        errs["fused_attn_fwd"] = max(errs["fused_attn_fwd"], *e_f)
        errs["fused_attn_bwd"] = max(errs["fused_attn_bwd"], *e_b)
        mask = ops["mask"]
        bounds = [bf16_bound(fused_cost(mask, h, d, w, vb=2))
                  for w in ("fwd", "bwd")]
        ratios = ""
        if (b, n, pad) == shapes[0]:
            args = [ops[k] for k in ("xa", "x", "cq", "ck", "c0")] + [vw] + [
                ops[k] for k in ("pe", "deg", "mask", "inv_sqrt")] + [g]
            with torch.inference_mode():
                got_f = [fa_mod.fused_attn_fwd(vw=vw, **ops)]
                got_b = fa_mod.fused_attn_bwd(vw=vw, g=g, **ops)
            ratios = ("; error from float64 over the CPU plain bf16 "
                      "route's: " + cpu32_ratios(
                          got_f, lambda a: [fa_mod.fused_attn_fwd_plain(
                              *a[:-1])], ("out",), args,
                          f"fused_attn_fwd {tag}", cpu_dtype=None,
                          factor=BF16_CPU_FACTOR) + " " + cpu32_ratios(
                          got_b, lambda a: fa_mod.fused_attn_bwd_plain(*a),
                          outs, args, f"fused_attn_bwd {tag}",
                          cpu_dtype=None, factor=BF16_CPU_FACTOR))
            for name, t, (bms, bby) in (("fused_attn_fwd", t_f, bounds[0]),
                                        ("fused_attn_bwd", t_b, bounds[1])):
                rows[name] = dict(ms_bf16=t[0], plain_ms_bf16=t[1],
                                  bound_ms_bf16=bms, bound_by_bf16=bby,
                                  ms_f32_twin=t[2])
        text = lambda t, bd: (f"{t[0]:.4f} ms (plain {t[1]:.4f} ms, float32 "
                              f"kernel {t[2]:.4f} ms, bound {bd[0]:.4f} ms "
                              f"{bd[1]}, {100 * bd[0] / t[0]:.2f} %)")
        print(f"fused-attention {tag} H={h} D={d} pad~{pad}: fwd err "
              f"{e_f[0]:.3e} {text(t_f, bounds[0])}; bwd err " + " ".join(
                  f"{o} {e:.3e}" for o, e in zip(outs, e_b))
              + f" {text(t_b, bounds[1])}; two runs of each bit-identical; "
              f"tolerance {BF16_KERNEL_TOL} (dcq, dck, dc0 {KERNEL_TOL})"
              + ratios, flush=True)
    for name in rows:
        rows[name]["max_abs_err_bf16"] = errs[name]
    return rows


def check_bf16_mlp(device, shapes=BF16_MLP_SHAPES, seed=7):
    """The bf16 phase's checks of the fused MLP pair (#12, #13) with bf16
    x, w1, w2 and g and float32 biases (`mlp_inputs`' values rounded to
    bf16: x, w1 and b1 lie on grids bf16 holds, so pre is exact) at each
    (rows, d_in, F, d_out, rates, tag) of `shapes`: each against its plain
    bf16 version on the card (`bf16_twin`: y and dx at BF16_KERNEL_TOL,
    db1 and db2 at KERNEL_TOL, dW1 and dW2, float32 sums of rounded dh and
    h, within BF16_KERNEL_TOL's rtol of their largest entry), two runs
    bit-identical, timed beside the float32 kernel on the same values and
    the bf16 bound. Returns each kernel's row fields, the "main" shape's
    at the largest rate (`ms_bf16`, ...) and each other tagged shape's
    (`ms_bf16_<tag>`, `bound_ms_bf16_<tag>`)."""
    bf = torch.bfloat16
    rows, errs = {}, {"fused_mlp_fwd": 0.0, "fused_mlp_bwd": 0.0}
    outs = ("dx", "dW1", "db1", "dW2", "db2")
    for r, din, f, dout, rates, tag in shapes:
        x, w1, b1, w2, b2, g = mlp_inputs(r + f + 1, r, din, f, dout, device,
                                          g_scale=mlp_g_scale(r))
        x, w1, w2, g = (t.to(bf) for t in (x, w1, w2, g))
        up = lambda *ts: [t.float() for t in ts]
        with torch.inference_mode():
            plain_b0 = fm_mod.fused_mlp_bwd_plain(x, w1, b1, w2, g)
        dw_tol = {o: dict(rtol=0, atol=BF16_KERNEL_TOL["rtol"] * float(
            t.abs().max())) for o, t in (("dW1", plain_b0[1]),
                                         ("dW2", plain_b0[3]))}
        del plain_b0
        tols = {**dw_tol, "db1": KERNEL_TOL, "db2": KERNEL_TOL}
        for rate in rates:
            label = f"bf16 R={r} d={din} rate={rate}"
            e_f, t_f = bf16_twin(
                "fused_mlp_fwd",
                lambda: [fm_mod.fused_mlp_fwd(x, w1, b1, w2, b2, rate, seed)],
                lambda: [fm_mod.fused_mlp_plain(x, w1, b1, w2, b2, rate,
                                                seed)],
                lambda: fm_mod.fused_mlp_fwd(*up(x, w1), b1, w2.float(), b2,
                                             rate, seed), ("y",), label)
            e_b, t_b = bf16_twin(
                "fused_mlp_bwd",
                lambda: fm_mod.fused_mlp_bwd(x, w1, b1, w2, g, rate, seed),
                lambda: fm_mod.fused_mlp_bwd_plain(x, w1, b1, w2, g, rate,
                                                   seed),
                lambda: fm_mod.fused_mlp_bwd(*up(x, w1), b1, *up(w2, g),
                                             rate, seed), outs, label, tols)
            errs["fused_mlp_fwd"] = max(errs["fused_mlp_fwd"], *e_f)
            errs["fused_mlp_bwd"] = max(errs["fused_mlp_bwd"], *e_b)
            bounds = [bf16_bound(mlp_cost(r, din, f, dout, w, vb=2))
                      for w in ("fwd", "bwd")]
            text = lambda t, bd: (
                f"{t[0]:.4f} ms (plain {t[1]:.4f} ms, float32 kernel "
                f"{t[2]:.4f} ms, bound {bd[0]:.4f} ms {bd[1]}, "
                f"{100 * bd[0] / t[0]:.2f} %)")
            print(f"fused-MLP {label} F={f} d_out={dout}: fwd err "
                  f"{e_f[0]:.3e} {text(t_f, bounds[0])}; bwd err "
                  + " ".join(f"{o} {e:.3e}" for o, e in zip(outs, e_b))
                  + f" {text(t_b, bounds[1])}; two runs of each "
                  f"bit-identical; tolerance {BF16_KERNEL_TOL} (db1, db2 "
                  f"{KERNEL_TOL}; dW1, dW2 atol "
                  f"{dw_tol['dW1']['atol']:.3e} / "
                  f"{dw_tol['dW2']['atol']:.3e})", flush=True)
            if rate != max(rates):
                continue
            for name, t, (bms, bby) in (("fused_mlp_fwd", t_f, bounds[0]),
                                        ("fused_mlp_bwd", t_b, bounds[1])):
                if tag == "main":
                    rows[name] = dict(ms_bf16=t[0], plain_ms_bf16=t[1],
                                      bound_ms_bf16=bms, bound_by_bf16=bby,
                                      ms_f32_twin=t[2])
                else:
                    rows.setdefault(name, {}).update({
                        f"ms_bf16_{tag}": t[0],
                        f"bound_ms_bf16_{tag}": bms})
    for name in rows:
        rows[name]["max_abs_err_bf16"] = errs[name]
    return rows


def canonical_signs(vecs):
    """Each eigenvector column with its largest-magnitude entry positive.
    An eigenvector's sign is arbitrary and LAPACK builds return different
    ones for the same graph, and the size of the SBM model's float32
    rounding error depends on them: fixing the sign makes every host check
    the same inputs."""
    cols = np.arange(vecs.shape[1])
    sign = np.sign(vecs[np.abs(vecs).argmax(0), cols])
    return (vecs * np.where(sign == 0, 1, sign)).astype(vecs.dtype)


def _pe_worker(graph):
    """Diffusion PE (beta 1) and LapPE of one graph."""
    DiffusionEncoding(beta=1.0).apply_to([graph])
    LapEncoding(MODEL_CFG["lap_pos_enc_dim"]).apply_to([graph])
    return graph.pe, canonical_signs(graph.lap_pe)


@contextlib.contextmanager
def worker_blas_threads(n):
    """n BLAS threads in each process spawned inside (their numpy reads
    these variables at import), so that a pool of one process a core does
    not run cores x cores threads."""
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: str(n) for k in keys})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def make_graphs(n_graphs=N_GRAPHS, n_nodes=N_NODES):
    graphs = sbm_like_dataset(seed=2, n_graphs=n_graphs, n_nodes=n_nodes)
    t0 = time.perf_counter()
    cores = os.cpu_count() or 1
    workers = max(1, min(len(graphs), cores))
    ctx = multiprocessing.get_context("spawn")
    with worker_blas_threads(max(1, cores // workers)), \
            ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        pes = pool.map(_pe_worker, graphs)
        for g, (pe, lap_pe) in zip(graphs, pes):
            g.pe, g.lap_pe = pe, lap_pe
    print(f"host PE (diffusion beta=1 + "
          f"LapPE 8) for {len(graphs)} graphs of "
          f"{min(g.num_nodes for g in graphs)}-"
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
    ref32 = Predictor(cpu_model, device="cpu", max_batch=2, **kw).predict(
        graphs[:2])
    cpu_s = time.perf_counter() - t0
    batch = collate_graphs(graphs[:2], **kw["collate_kwargs"])
    with torch.inference_mode():
        logits = cpu_model.to(torch.float64)(as_float64(batch))[0].numpy()
    ref = [logits[i, :g.num_nodes] for i, g in enumerate(graphs[:2])]
    gap = lambda got: max(float(np.abs(o - r).max())
                          for o, r in zip(got, ref))
    err, err32 = gap(outs[0][:2]), gap(ref32)
    for o, r in zip(outs[0][:2], ref):
        np.testing.assert_allclose(o, r, **SLICE_TOL)

    steady = statistics.median(call_ms[1:3])
    print(f"slice: {forwards} requests {[len(r) for r in requests]} at "
          f"N={N_NODES}; ms/call {[round(t, 2) for t in call_ms]}; "
          f"steady {steady:.2f} ms/call for {N_GRAPHS} graphs = "
          f"{N_GRAPHS / steady * 1e3:.1f} graphs/s on {card}", flush=True)
    scale = max(float(np.abs(r).max()) for r in ref)
    print(f"slice: launches {launches}; logits of 2 graphs against the CPU "
          f"path in float64: max abs err CUDA {err:.3e} (tolerance rtol 1e-3 "
          f"atol 1e-3), CPU float32 {err32:.3e}; max |logit| {scale:.3f} "
          f"(CPU float32 path {cpu_s:.1f} s)", flush=True)
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
                TrainConfig(regularization=0.1, sign_flip=False), STEP_PARAMS,
                loss_rtol=SBM_STEP_LOSS_RTOL)
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


def make_zinc_graphs():
    """bench.py's ZINC data (bench.py:142-146), four requests' worth:
    zinc_like_dataset with diffusion PE (beta 1) and LapPE 8."""
    t0 = time.perf_counter()
    graphs = zinc_like_dataset(seed=0, n_graphs=ZINC_REQUESTS * ZINC_GRAPHS)
    DiffusionEncoding(beta=1.0).apply_to(graphs)
    LapEncoding(dim=ZINC_CFG["lap_pos_enc_dim"]).apply_to(graphs)
    sizes = [g.num_nodes for g in graphs]
    print(f"host PE (diffusion beta=1 + LapPE 8) for {len(graphs)} ZINC-like "
          f"graphs of {min(sizes)}-{max(sizes)} nodes: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return graphs


def zinc_serve(graphs, device, card, impl, profile=False, tag=""):
    """Phase 8: DiffGraphTransformerGenGCN served through Predictor on
    CUDA under one attention route, requests of 128 distinct graphs; on the
    "fused" route 8 graphs are also held against the CPU path. Returns the
    launches, the steady ms/request and a function that serves one more
    request. `tag` marks the printed lines (the bf16 phase's runs)."""
    n_req = ZINC_RUNS[impl][0]
    model = DiffGraphTransformerGenGCN(**ZINC_CFG, attention_impl=impl,
                                       seed=0, device=device)
    calibrate_batch_norm(model, collate_graphs(
        graphs[:ZINC_GRAPHS], max_nodes=ZINC_NODES), device)
    kw = dict(collate_kwargs={"max_nodes": ZINC_NODES},
              max_batch=ZINC_GRAPHS)
    pred = Predictor(model, device=device, **kw)
    requests = [graphs[i * ZINC_GRAPHS:(i + 1) * ZINC_GRAPHS]
                for i in range(n_req)]
    reset_launches()
    outs, call_ms = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(pred.predict(req))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    want = {k: n_req * v for k, v in ZINC_REQUEST_LAUNCHES[impl].items()}
    if launches != want:
        raise AssertionError(f"zinc {impl}{tag}: launch counts {launches} for "
                             f"{n_req} requests; expected "
                             f"{ZINC_REQUEST_LAUNCHES[impl]} each")
    for out in outs:
        if out.shape != (ZINC_GRAPHS, 1) or not np.isfinite(out).all():
            raise AssertionError(f"bad ZINC outputs {out.shape}")
    steady = statistics.median(call_ms[1:])
    print(f"zinc serve [{impl}{tag}]: {n_req} requests of {ZINC_GRAPHS} graphs at "
          f"N={ZINC_NODES}; ms/call {[round(t, 2) for t in call_ms]}; steady "
          f"(median after the first) {steady:.2f} ms/call = "
          f"{ZINC_GRAPHS / steady * 1e3:.1f} graphs/s on {card}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if impl == "fused":
        n_ref = 8
        cpu_model = copy.deepcopy(model).to("cpu")
        ref = Predictor(cpu_model, device="cpu", **kw).predict(
            requests[0][:n_ref])
        err = float(np.abs(outs[0][:n_ref] - ref).max())
        np.testing.assert_allclose(outs[0][:n_ref], ref, **SLICE_TOL)
        print(f"zinc serve [{impl}{tag}]: CUDA vs CPU outputs of {n_ref} graphs: "
              f"max abs err {err:.3e}, max |y| {float(np.abs(ref).max()):.3f}"
              f" (tolerance rtol 1e-3 atol 1e-3)", flush=True)
    if profile:
        profile_call(f"one ZINC request of {ZINC_GRAPHS} graphs [{impl}{tag}]",
                     lambda: pred.predict(requests[0]))
    return launches, steady, lambda: pred.predict(requests[0])


def zinc_train(graphs, device, card, impl, profile=False, tag=""):
    """Phase 9: DiffGraphTransformerGenGCN trained through Trainer
    (graph_reg, L1) on CUDA under one attention route, bench.py's step:
    AdamW at lr 1e-3, weight decay 1e-5, LapPE sign flip on, on 2 batches of
    128 graphs; warm-up epochs, then a timed window. On the "fused" route
    one step on 16 graphs is also held against a float64 CPU step. Returns
    the launches, the window's ms/step and a function that trains one more
    epoch and returns its ms/step. `tag` as in `zinc_serve`."""
    _, warm, timed = ZINC_RUNS[impl]
    model = DiffGraphTransformerGenGCN(**ZINC_CFG, attention_impl=impl,
                                       seed=1, device=device)
    initial = copy.deepcopy(model)
    batches = [collate_graphs(graphs[i:i + ZINC_GRAPHS],
                              max_nodes=ZINC_NODES).to(device)
               for i in (0, ZINC_GRAPHS)]
    trainer = Trainer(model, TrainConfig(task="graph_reg", lr=1e-3,
                                         weight_decay=1e-5, sign_flip=True,
                                         seed=0))
    reset_launches()
    losses, _ = timed_epochs(trainer, batches, warm)
    more, window = timed_epochs(trainer, batches, timed)
    launches = read_launches()
    syncs = step_syncs(trainer, batches[0])
    total = (warm + timed) * len(batches)
    per_step = [r[0] / len(batches) for r in window]
    mean = sum(r[0] for r in window) / (timed * len(batches))
    spread = statistics.stdev(per_step) if len(per_step) > 1 else 0.0
    print(f"zinc train [{impl}{tag}]: {warm} warm-up + {timed} timed epochs of "
          f"{len(batches)} steps of {ZINC_GRAPHS} graphs at N={ZINC_NODES} "
          f"(L1, AdamW lr 1e-3, weight decay 1e-5, sign flip on): "
          f"{mean:.2f} ms/step over the window; per epoch ms/step median "
          f"{statistics.median(per_step):.2f}, min {min(per_step):.2f}, max "
          f"{max(per_step):.2f}, stdev {spread:.2f}; process CPU ms/epoch "
          f"{[round(r[2], 2) for r in window]}; epoch losses "
          f"{[round(x, 6) for x in losses + more]}; launches "
          f"{ {k: v for k, v in launches.items() if v} } over {total} steps; "
          f"host syncs in one step (sync debug mode): {len(syncs)} "
          f"{syncs[:3]}; on {card}", flush=True)
    want = {k: total * v for k, v in ZINC_STEP_LAUNCHES[impl].items()}
    if launches != want:
        raise AssertionError(f"zinc {impl}{tag}: launch counts {launches} for "
                             f"{total} steps; expected "
                             f"{ZINC_STEP_LAUNCHES[impl]} per step")
    if not all(np.isfinite(losses + more)):
        raise AssertionError(f"zinc {impl}{tag}: epoch losses {losses + more}")
    if syncs:
        raise AssertionError(f"a ZINC training step [{impl}{tag}] syncs the "
                             f"host: {syncs}")
    if profile:
        profile_call(f"one ZINC training step of {ZINC_GRAPHS} graphs "
                     f"[{impl}{tag}]", lambda: trainer.step(batches[0]))
    if impl == "fused":
        step_parity(initial, graphs[:16], device, f"zinc train [{impl}{tag}]",
                    dict(max_nodes=ZINC_NODES),
                    TrainConfig(task="graph_reg", regularization=0.1,
                                sign_flip=False), STEP_PARAMS)

    def step_ms():
        """ms/step of one more epoch."""
        return timed_epochs(trainer, batches, 1)[1][0][0] / len(batches)

    return launches, mean, step_ms


def compare_routes(request_fns, step_fns, card, label, rounds):
    """The routes in turns: each of `rounds` rounds serves one request and
    trains one epoch on every route, the order rotating from round to
    round, so that a change in the host's speed (which sets these times,
    PERF.md section 5) falls on every route alike. Prints each route's
    median and quartiles of ms/request and ms/step over the rounds, and the
    rounds in which it was the fastest."""
    names = list(request_fns)
    req = {k: [] for k in names}
    step = {k: [] for k in names}
    for r in range(rounds):
        for impl in names[r % len(names):] + names[:r % len(names)]:
            t0 = time.perf_counter()
            request_fns[impl]()
            req[impl].append((time.perf_counter() - t0) * 1e3)
            step[impl].append(step_fns[impl]())

    def summary(times):
        wins = {k: sum(min(names, key=lambda n: times[n][r]) == k
                       for r in range(rounds)) for k in names}
        return "; ".join(
            f"{k} median {statistics.median(v):.2f} (quartiles "
            + " / ".join(f"{q:.2f}" for q in statistics.quantiles(v, n=4))
            + f", fastest in {wins[k]} rounds)" for k, v in times.items())

    print(f"{label}, {rounds} interleaved rounds: ms/request "
          f"{summary(req)}", flush=True)
    print(f"{label}, {rounds} interleaved rounds: ms/step {summary(step)}; "
          f"on {card}", flush=True)


def zinc_slice(device, card, profile=False):
    """Phases 8-9 on each attention route, the main path ("fused") first,
    then the routes' times in interleaved rounds; returns the launches of
    every phase."""
    graphs = make_zinc_graphs()
    runs, served, trained, request_fns, step_fns = [], {}, {}, {}, {}
    for impl in ZINC_RUNS:
        launches, served[impl], request_fns[impl] = zinc_serve(
            graphs, device, card, impl, profile and impl == "fused")
        runs.append(launches)
        launches, trained[impl], step_fns[impl] = zinc_train(
            graphs, device, card, impl, profile and impl == "fused")
        runs.append(launches)
    print(f"zinc routes at B={ZINC_GRAPHS}, N={ZINC_NODES} (ms/request "
          "steady, ms/step over the window of each phase): " + "; ".join(
              f"{impl} {served[impl]:.2f} / {trained[impl]:.2f}"
              for impl in ZINC_RUNS) + f"; on {card}", flush=True)
    compare_routes(request_fns, step_fns, card,
                   f"zinc routes at B={ZINC_GRAPHS}, N={ZINC_NODES}",
                   ZINC_ROUNDS)
    return runs


def large_serve(graphs, device, card, setting, profile=False):
    """The N=2048 slice served through Predictor on CUDA under one setting
    of the attention dispatch: requests of 2 graphs (B=2, ragged N padded
    to 2048), exact launch counts; under "fold" one graph's logits are held
    to a float64 forward on the CPU. Returns the launches, the median
    ms/request and a function that serves one more request."""
    n_req = LARGE_RUNS[setting][0]
    collate = {"max_nodes": LARGE_N, "node_labels": True}
    model = DiffGraphTransformerGenGCNSBM(
        **LARGE_CFG, **LARGE_SETTINGS[setting], seed=0, device=device)
    calibrate_batch_norm(model, collate_graphs(graphs[:2], **collate), device)
    pred = Predictor(model, device=device, max_batch=2, node_level=True,
                     collate_kwargs=collate)
    requests = [graphs[2 * i:2 * i + 2] for i in range(n_req)]
    reset_launches()
    outs, call_ms = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(pred.predict(req))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    want = {k: n_req * v for k, v in LARGE_REQUEST_LAUNCHES[setting].items()}
    if launches != want:
        raise AssertionError(f"N={LARGE_N} {setting}: launch counts "
                             f"{launches} for {n_req} requests; expected "
                             f"{LARGE_REQUEST_LAUNCHES[setting]} each")
    for req, out in zip(requests, outs):
        for g, o in zip(req, out):
            if o.shape != (g.num_nodes, MODEL_CFG["nb_class"]) or \
                    not np.isfinite(o).all():
                raise AssertionError(f"bad logits {o.shape}")
    steady = statistics.median(call_ms)
    print(f"large serve [{setting}]: {n_req} requests of 2 graphs "
          f"({[[g.num_nodes for g in r] for r in requests]} nodes) at "
          f"N={LARGE_N}; ms/call {[round(t, 2) for t in call_ms]}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; on {card}",
          flush=True)
    if setting == "fold":
        t0 = time.perf_counter()
        errs = logits_errors(model, graphs, collate,
                             lambda: pred.predict(requests[0])[0])
        print(f"large serve [{setting}]: logits of one graph "
              f"({graphs[0].num_nodes} nodes) against the CPU path in "
              f"float64: max abs err CUDA {errs['cuda']:.3e}, CPU float32 "
              f"{errs['cpu32']:.3e}; max |logit| {errs['scale']:.3f} "
              f"(tolerance: rtol 1e-3 atol 1e-3, or {LOGITS_CPU32_FACTOR}x "
              f"the CPU float32 route's error; CPU forwards "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)
        if not (errs["within"]
                or errs["cuda"] <= LOGITS_CPU32_FACTOR * errs["cpu32"]):
            raise AssertionError(f"N={LARGE_N} logits off float64: {errs}")
    if profile:
        profile_call(f"one request of 2 graphs at N={LARGE_N} [{setting}]",
                     lambda: pred.predict(requests[0]))
    return launches, steady, lambda: pred.predict(requests[0])


def large_train(graphs, device, card, setting, profile=False):
    """The N=2048 slice trained through Trainer (node_clf, AdamW, warmup
    towards lr 1e-3, weight decay 1e-5, sign flip on) on CUDA under one
    setting, one graph a step (examples/largen_combo_ab.py's step): warm-up
    epochs over the 4 graphs, then a timed window; exact launch counts,
    finite loss and no host sync in a step; under "fold" a falling loss,
    and one step on one graph held to a float64 CPU step. Returns the
    launches, the window's ms/step and a function that trains one more
    epoch and returns its ms/step."""
    _, warm, timed = LARGE_RUNS[setting]
    model = DiffGraphTransformerGenGCNSBM(
        **LARGE_CFG, **LARGE_SETTINGS[setting], seed=1, device=device)
    initial = copy.deepcopy(model)
    batches = [collate_graphs([g], max_nodes=LARGE_N, node_labels=True)
               .to(device) for g in graphs]
    trainer = Trainer(model, TrainConfig(lr=1e-3, weight_decay=1e-5,
                                         sign_flip=True, seed=0,
                                         schedule="warmup",
                                         warmup_steps=warm * len(batches)))
    reset_launches()
    losses, _ = timed_epochs(trainer, batches, warm)
    more, window = timed_epochs(trainer, batches, timed)
    launches = read_launches()
    syncs = step_syncs(trainer, batches[0])
    total = (warm + timed) * len(batches)
    per_step = [r[0] / len(batches) for r in window]
    mean = sum(r[0] for r in window) / (timed * len(batches))
    print(f"large train [{setting}]: {warm} warm-up + {timed} timed epochs "
          f"of {len(batches)} one-graph steps at N={LARGE_N}: {mean:.2f} "
          f"ms/step over the window; per epoch ms/step median "
          f"{statistics.median(per_step):.2f}, min {min(per_step):.2f}, max "
          f"{max(per_step):.2f}; process CPU ms/epoch "
          f"{[round(r[2], 2) for r in window]}; epoch losses "
          f"{[round(x, 6) for x in losses + more]}; launches "
          f"{ {k: v for k, v in launches.items() if v} } over {total} steps; "
          f"host syncs in one step (sync debug mode): {len(syncs)} "
          f"{syncs[:3]}; on {card}", flush=True)
    want = {k: total * v for k, v in LARGE_STEP_LAUNCHES[setting].items()}
    if launches != want:
        raise AssertionError(f"N={LARGE_N} {setting}: launch counts "
                             f"{launches} for {total} steps; expected "
                             f"{LARGE_STEP_LAUNCHES[setting]} per step")
    epochs = losses + more
    if not all(np.isfinite(epochs)):
        raise AssertionError(f"N={LARGE_N} {setting}: epoch losses {epochs}")
    if syncs:
        raise AssertionError(f"a training step at N={LARGE_N} [{setting}] "
                             f"syncs the host: {syncs}")
    if profile:
        profile_call(f"one training step of 1 graph at N={LARGE_N} "
                     f"[{setting}]", lambda: trainer.step(batches[0]))
    if setting == "fold":
        if not epochs[-1] < epochs[0]:
            raise AssertionError(f"epoch losses {epochs}: not falling")
        step_parity(initial, graphs[:1], device, f"large train [{setting}]",
                    dict(max_nodes=LARGE_N, node_labels=True),
                    TrainConfig(regularization=0.1, sign_flip=False),
                    LARGE_STEP_PARAMS, loss_rtol=SBM_STEP_LOSS_RTOL,
                    cpu_factor=STEP_CPU32_FACTOR)

    def step_ms():
        """ms/step of one more epoch."""
        return timed_epochs(trainer, batches, 1)[1][0][0] / len(batches)

    return launches, mean, step_ms


def large_slice(device, card, profile=False):
    """The N=2048 slice under each setting, the main path ("fold") first,
    then the settings' times in interleaved rounds; returns the launches
    of every phase."""
    graphs = make_graphs(LARGE_GRAPHS, LARGE_N)
    runs, served, trained, request_fns, step_fns = [], {}, {}, {}, {}
    for setting in LARGE_RUNS:
        launches, served[setting], request_fns[setting] = large_serve(
            graphs, device, card, setting, profile and setting == "fold")
        runs.append(launches)
        launches, trained[setting], step_fns[setting] = large_train(
            graphs, device, card, setting, profile and setting == "fold")
        runs.append(launches)
    print(f"large settings at N={LARGE_N} (ms/request median, ms/step over "
          "the window of each phase): " + "; ".join(
              f"{s} {served[s]:.2f} / {trained[s]:.2f}" for s in LARGE_RUNS)
          + f"; on {card}", flush=True)
    compare_routes(request_fns, step_fns, card,
                   f"large settings at N={LARGE_N} (requests of 2 graphs, "
                   "steps of 1)", LARGE_ROUNDS)
    return runs


def molhiv_logits_check(model, graphs, served, n_nodes, label, stride=1):
    """Every `stride`-th graph of `served` (the CUDA logits of `graphs` at
    padding `n_nodes`) against a float64 forward of the same graphs on the
    CPU, within SLICE_TOL; prints the CPU float32 route's error beside."""
    ref_graphs = graphs[::stride]
    batch = collate_graphs(ref_graphs, max_nodes=n_nodes)
    with torch.inference_mode():
        ref = copy.deepcopy(model).to("cpu", torch.float64)(
            as_float64(batch))[0].numpy()
        ref32 = copy.deepcopy(model).to("cpu")(batch)[0].numpy()
    got = served[::stride]
    real = np.isfinite(ref)
    gap = lambda a: float(np.abs(a - ref)[real].max()) if real.any() else 0.
    which = f"every {stride}th of" if stride > 1 else "all"
    print(f"{label}: CUDA logits of {len(ref_graphs)} graphs ({which} "
          f"{len(graphs)}) at N={n_nodes} against float64 on the CPU: max abs err {gap(got):.3e} (CPU "
          f"float32 {gap(ref32):.3e}; max |logit| "
          f"{float(np.abs(ref[real]).max()) if real.any() else 0.:.3f}; "
          f"NaN in {int((~real).sum())} graphs, at the same ones on CUDA: "
          f"{bool(np.array_equal(np.isnan(got), ~real))}; tolerance rtol "
          f"1e-3 atol 1e-3)", flush=True)
    np.testing.assert_allclose(got, ref, equal_nan=True, **SLICE_TOL)


def molhiv_serve(model, graphs, device, card, n_nodes, label, finite=True,
                 profile=False):
    """MOLHIV_REQUESTS requests of `graphs` through Predictor at padding
    `n_nodes`, launch counts read around them, each request's logits the
    same (and, with `finite`, finite); with `profile`, one more request
    traced; returns (launches, the first request's logits)."""
    pred = Predictor(model, device=device, max_batch=MOLHIV_GRAPHS,
                     collate_kwargs={"max_nodes": n_nodes})
    reset_launches()
    outs, call_ms = [], []
    for _ in range(MOLHIV_REQUESTS):
        t0 = time.perf_counter()
        outs.append(pred.predict(graphs))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    want = {k: MOLHIV_REQUESTS * v
            for k, v in MOLHIV_REQUEST_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} for "
                             f"{MOLHIV_REQUESTS} requests; expected "
                             f"{MOLHIV_REQUEST_LAUNCHES} each")
    for out in outs:
        if out.shape != (len(graphs),) or (finite
                                            and not np.isfinite(out).all()):
            raise AssertionError(f"{label}: bad logits {out}")
        if not np.array_equal(out, outs[0], equal_nan=True):
            raise AssertionError(f"{label}: two requests differ")
    steady = statistics.median(call_ms[1:])
    print(f"{label}: {MOLHIV_REQUESTS} requests of {len(graphs)} graphs at "
          f"N={n_nodes}; ms/call {[round(t, 2) for t in call_ms]}; steady "
          f"(median after the first) {steady:.2f} ms/request = "
          f"{len(graphs) / steady * 1e3:.1f} graphs/s on {card}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if profile:
        profile_call(f"one molhiv request of {len(graphs)} graphs at "
                     f"N={n_nodes}", lambda: pred.predict(graphs))
    return launches, outs[0]


def molhiv_slice(device, card, profile=False):
    """The molhiv phase: serving at the batch's own padding and at
    N = 222, the fixture's real molecules, then 3 binary_graph steps;
    returns the launches of each run."""
    graphs = ogb_like_dataset(seed=0, n_graphs=MOLHIV_GRAPHS)
    own_n = max(g.num_nodes for g in graphs)
    model = DiffGraphTransformerGenGCNMolHiv(**MOLHIV_CFG, seed=0,
                                             device=device)
    runs, served = [], {}
    for n_nodes in (own_n, MOLHIV_REAL_N):
        label = f"molhiv serve N={n_nodes}"
        launches, served[n_nodes] = molhiv_serve(model, graphs, device,
                                                 card, n_nodes, label,
                                                 profile=profile)
        runs.append(launches)
        molhiv_logits_check(model, graphs, served[n_nodes], n_nodes, label,
                            1 if n_nodes == own_n else MOLHIV_REF_STRIDE)
    gap = float(np.abs(served[own_n] - served[MOLHIV_REAL_N]).max())
    auc = task_metric("binary_graph", served[own_n],
                      np.array([g.y for g in graphs]))["rocauc"]
    print(f"molhiv serve: logits at N={own_n} and N={MOLHIV_REAL_N} differ "
          f"by at most {gap:.3e}; ROC-AUC of the served logits against the "
          f"synthetic labels {auc:.4f}", flush=True)
    if not np.isfinite(auc):
        raise AssertionError(f"molhiv: ROC-AUC {auc}")
    if gap > SLICE_TOL["atol"] + SLICE_TOL["rtol"] * float(
            np.abs(served[own_n]).max()):
        raise AssertionError(f"molhiv: logits depend on the padding ({gap})")
    # The fixture's atom ids run 0-19 in every column
    # (tests/fixtures/make_fixtures.py), past most of OGB's vocabularies;
    # the port's atom encoder gives such atoms NaN, as the JAX package's
    # does. So its molecules are served as read (NaN where float64 has
    # NaN), then with each id taken modulo its column's vocabulary.
    real = load_ogb_graphs(MOLHIV_FIXTURES, "ogbg-molhiv")
    dims = np.array(ATOM_FEATURE_DIMS, np.int32)
    folded = [dataclasses.replace(g, x=g.x % dims) for g in real]
    for gs, how in ((real, "as read"), (folded, "ids modulo the vocab")):
        label = f"molhiv serve, ogbg-molhiv fixture ({how})"
        launches, out = molhiv_serve(model, gs, device, card, MOLHIV_REAL_N,
                                     label, finite=gs is folded)
        runs.append(launches)
        molhiv_logits_check(model, gs, out, MOLHIV_REAL_N, label)
        print(f"{label}: {len(gs)} molecules of "
              f"{min(g.num_nodes for g in gs)}-"
              f"{max(g.num_nodes for g in gs)} atoms, labels "
              f"{[int(g.y) for g in gs]}, logits "
              f"{[round(float(v), 4) for v in out]}", flush=True)

    train_model = DiffGraphTransformerGenGCNMolHiv(**MOLHIV_CFG, seed=1,
                                                   device=device)
    initial = copy.deepcopy(train_model)
    batch = collate_graphs(graphs, max_nodes=own_n).to(device)
    trainer = Trainer(train_model, TrainConfig(
        task="binary_graph", lr=1e-3, weight_decay=1e-4, schedule="warmup",
        warmup_steps=MOLHIV_STEPS, sign_flip=False, seed=0))
    reset_launches()
    t0 = time.perf_counter()
    losses = [float(trainer.step(batch)) for _ in range(MOLHIV_STEPS)]
    step_ms = (time.perf_counter() - t0) * 1e3 / MOLHIV_STEPS
    launches = read_launches()
    runs.append(launches)
    want = {k: MOLHIV_STEPS * v for k, v in MOLHIV_STEP_LAUNCHES.items()}
    print(f"molhiv train: {MOLHIV_STEPS} steps (binary_graph, sigmoid BCE, "
          f"AdamW lr 1e-3 warming up over {MOLHIV_STEPS} steps) of "
          f"{MOLHIV_GRAPHS} graphs at N={own_n}: losses "
          f"{[round(x, 6) for x in losses]}, {step_ms:.2f} ms/step (with the "
          f"host syncs of reading each loss) on {card}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; metric of the "
          f"trained model {trainer.evaluate([batch])}", flush=True)
    if launches != want:
        raise AssertionError(f"molhiv train: launch counts {launches}; "
                             f"expected {MOLHIV_STEP_LAUNCHES} per step")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"molhiv train: losses {losses}")
    if profile:
        profile_call(f"one molhiv training step of {MOLHIV_GRAPHS} graphs "
                     f"at N={own_n}", lambda: trainer.step(batch))
    step_parity(initial, graphs[:16], device, "molhiv train",
                dict(max_nodes=own_n),
                TrainConfig(task="binary_graph", regularization=0.1,
                            sign_flip=False), MOLHIV_STEP_PARAMS)
    return runs


def lpe_build(config, overrides, trainer, device, seed):
    """A net of the lpe phase as its config trainer builds it: (model, its
    graphs' transform, the Trainer task, collate kwargs beyond max_nodes,
    the graph maker)."""
    cfg = load_config(os.path.join(ROOT, config))
    cfg["net_params"].update(overrides)
    if trainer == "sbm":
        cls, kw = cli_sbm_config.resolve_build(cfg)
        model = cli_sbm_config.construct_model(cls, kw, 3, 2, device=device,
                                               seed=seed)

        def make(n_graphs):
            tr, va, te, _ = load_sbm_or_synthetic(
                "no-dataset", cfg["dataset"], seed=5, n_synthetic=n_graphs,
                n_nodes=PATTERN_NODES)
            return tr + va + te
        return (model, lambda gs: apply_laplace_decomp(gs, SAN_FREQS),
                "node_clf", {"node_labels": True}, make, cfg)
    cls, kw = cli_zinc_config.resolve_build(cfg)
    model = cli_zinc_config.construct_model(cls, kw, device=device,
                                            seed=seed)
    return (model, lambda gs: cli_zinc_config.pe_precompute(
                gs, cls, kw, cfg, max_freqs=SAN_FREQS), "graph_reg", {},
            lambda n: zinc_categorical_dataset(seed=7, n_graphs=n), cfg)


def lpe_ref_check(model, graphs, served, collate, label):
    """The first LPE_REF_GRAPHS served logits (per node where `served` is
    per node) against a float64 forward of those graphs on the CPU, within
    SLICE_TOL; the CPU float32 route's error printed beside."""
    ref_graphs = graphs[:LPE_REF_GRAPHS]
    batch = collate_graphs(ref_graphs, **collate)
    with torch.inference_mode():
        ref = copy.deepcopy(model).to("cpu", torch.float64)(
            as_float64(batch)).numpy()
        ref32 = copy.deepcopy(model).to("cpu")(batch).numpy()
    pick = lambda a, i: a[i, :g.num_nodes] if a.ndim == 3 else a[i]
    errs = {"cuda": 0.0, "cpu32": 0.0}
    for i, g in enumerate(ref_graphs):
        want = pick(ref, i)
        np.testing.assert_allclose(served[i], want, **SLICE_TOL)
        errs["cuda"] = max(errs["cuda"],
                           float(np.abs(served[i] - want).max()))
        errs["cpu32"] = max(errs["cpu32"],
                            float(np.abs(pick(ref32, i) - want).max()))
    print(f"{label}: CUDA logits of {len(ref_graphs)} graphs against float64"
          f" on the CPU: max abs err {errs['cuda']:.3e} (CPU float32 "
          f"{errs['cpu32']:.3e}; max |logit| {float(np.abs(ref).max()):.3f};"
          f" tolerance rtol 1e-3 atol 1e-3)", flush=True)


def lpe_net(spec, device, card, profile=False):
    """One net of the lpe phase, served and trained on the card; returns
    the launches of its requests and of its steps."""
    label, config, overrides, trainer, per, nodes, heads, params = spec
    model, transform, task, extra, make, cfg = lpe_build(
        config, overrides, trainer, device, seed=0)
    graphs = make(max(LPE_REQUESTS, 2) * per)
    transform(graphs)
    collate = dict(max_nodes=nodes, **extra)
    sizes = [g.num_nodes for g in graphs]
    rows = ("none" if not heads else f"{per * nodes * SAN_FREQS} rows"
            if overrides.get("LPE") != "edge"
            else f"B*N*N*m = {per * nodes * nodes * SAN_FREQS} rows")
    print(f"lpe {label}: {type(model).__name__} from {config} "
          f"{overrides or ''} ({sum(p.numel() for p in model.parameters())} "
          f"parameters); {len(graphs)} graphs of {min(sizes)}-{max(sizes)} "
          f"nodes padded to N={nodes}, batches of {per}; eigen-PE FFN "
          f"{rows}", flush=True)
    calibrate_batch_norm(model, collate_graphs(graphs[:per], **collate),
                         device)
    pred = Predictor(model, device=device, max_batch=per,
                     collate_kwargs=collate, node_level=task == "node_clf")
    requests = [graphs[i * per:(i + 1) * per] for i in range(LPE_REQUESTS)]
    reset_launches()
    outs, call_ms = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(pred.predict(req))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    served = read_launches()
    want = {**NONE, "fused_mlp_fwd": heads * LPE_REQUESTS}
    if served != want:
        raise AssertionError(f"lpe {label}: launch counts {served} for "
                             f"{LPE_REQUESTS} requests; expected {heads} "
                             "fused_mlp_fwd each")
    for out in outs:
        if not all(np.isfinite(np.asarray(o, np.float64)).all()
                   for o in out):
            raise AssertionError(f"lpe {label}: non-finite logits")
    steady = statistics.median(call_ms[1:])
    print(f"lpe {label} serve: {LPE_REQUESTS} requests of {per} graphs; "
          f"ms/request {[round(t, 2) for t in call_ms]}, steady {steady:.2f}"
          f" ms = {per / steady * 1e3:.1f} graphs/s on {card}; launches "
          f"{ {k: v for k, v in served.items() if v} }", flush=True)
    lpe_ref_check(model, requests[0], outs[0], collate, f"lpe {label} serve")
    if profile:
        profile_call(f"one lpe {label} request of {per} graphs",
                     lambda: pred.predict(requests[0]))

    model, *_ = lpe_build(config, overrides, trainer, device, seed=1)
    initial = copy.deepcopy(model)
    batches = [collate_graphs(graphs[i * per:(i + 1) * per], **collate)
               .to(device) for i in range(2)]
    p = cfg["params"]
    steps = LPE_EPOCHS * len(batches)
    sign_flip = heads > 0
    trainer_ = Trainer(model, TrainConfig(
        task=task, lr=p["init_lr"], weight_decay=p["weight_decay"],
        schedule="warmup", warmup_steps=steps, sign_flip=sign_flip, seed=0))
    reset_launches()
    losses, first = timed_epochs(trainer_, batches, LPE_EPOCHS)
    more, window = timed_epochs(trainer_, batches, LPE_TIMED_EPOCHS)
    trained = read_launches()
    syncs = step_syncs(trainer_, batches[0])
    total = steps + LPE_TIMED_EPOCHS * len(batches)
    per_step = [r[0] / len(batches) for r in window]
    print(f"lpe {label} train: {total} AdamW steps of {per} graphs (warmup "
          f"towards lr {p['init_lr']}, weight decay {p['weight_decay']}, "
          f"layer dropout {cfg['net_params'].get('dropout', 0.0)}, eigen-PE "
          f"dropout 0.1, sign flip {sign_flip}); epoch losses "
          f"{[round(x, 6) for x in losses + more]}; timed window "
          f"{sum(r[0] for r in window) / (len(window) * len(batches)):.2f} "
          f"ms/step (per epoch median {statistics.median(per_step):.2f}, "
          f"min {min(per_step):.2f}, max {max(per_step):.2f}) on {card}; "
          f"launches { {k: v for k, v in trained.items() if v} }; host syncs "
          f"in one step: {len(syncs)} {syncs[:3]}", flush=True)
    if profile:
        profile_call(f"one lpe {label} training step of {per} graphs",
                     lambda: trainer_.step(batches[0]))
    want = {**NONE, "fused_mlp_fwd": heads * total,
            "fused_mlp_bwd": heads * total}
    if trained != want:
        raise AssertionError(f"lpe {label}: launch counts {trained} for "
                             f"{total} steps; expected {heads} + {heads} "
                             "fused-MLP launches a step")
    if not all(np.isfinite(losses + more)):
        raise AssertionError(f"lpe {label}: epoch losses {losses + more}")
    if syncs:
        raise AssertionError(f"lpe {label}: a training step syncs the host: "
                             f"{syncs}")
    step_cfg = TrainConfig(task=task, sign_flip=False)
    step_parity(initial, graphs[:LPE_REF_GRAPHS], device, f"lpe {label} "
                "train", collate, step_cfg, params, rank=task == "node_clf")
    if task == "node_clf":
        # the same step with the eigen-PE head's fused MLP on its plain
        # version on the card: does the kernels' rounding lead the gap?
        with plain_mlp():
            names = [n for n, _ in initial.named_parameters()]
            _, rel, scale, _ = step_errors(
                initial, graphs[:LPE_REF_GRAPHS], device, collate, step_cfg,
                names, names)
        rank_step_errors(f"lpe {label} train, the fused MLP's plain version "
                         "on the card", rel, scale)
    return [served, trained]


def lpe_slice(device, card, profile=False):
    """The lpe phase: each of LPE_NETS served and trained; returns the
    launches of every run."""
    t0 = time.perf_counter()
    runs = []
    for spec in LPE_NETS:
        runs += lpe_net(spec, device, card, profile=profile)
    print(f"lpe phase: {len(LPE_NETS)} nets in "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    return runs


def lspe_graphs(spec, n_graphs):
    """The graphs of an lspe net and the task: ZINC-shaped molecules, or
    synthetic PATTERN SBMs of up to PATTERN_NODES nodes."""
    if spec[4] == "sbm":
        tr, va, te, _ = load_sbm_or_synthetic(
            "no-dataset", "SBM_PATTERN", seed=5, n_synthetic=n_graphs,
            n_nodes=PATTERN_NODES)
        return tr + va + te, "node_clf", {"node_labels": True}
    return zinc_categorical_dataset(seed=7, n_graphs=n_graphs), \
        "graph_reg", {}


def lspe_build(spec, graphs, device, seed, transform=False):
    """An lspe net as its config trainer builds it (PNA with the graphs'
    degree statistic); with `transform`, the trainer's PE precompute on
    `graphs` first. Returns (model, cfg)."""
    _, config, model_arg, kw_over, trainer, *_ = spec
    cfg = load_config(os.path.join(ROOT, config))
    if trainer == "sbm":
        cls, kw = cli_sbm_config.resolve_build(cfg, model_arg)
        if transform:
            cli_sbm_config.pe_precompute(graphs, cls, kw, cfg)
        return cli_sbm_config.construct_model(
            cls, dict(kw, **kw_over), 3, 2, device=device, seed=seed), cfg
    cls, kw = cli_zinc_config.resolve_build(cfg, model_arg)
    if transform:
        cli_zinc_config.pe_precompute(graphs, cls, kw, cfg)
    return cli_zinc_config.construct_model(
        cls, dict(kw, **kw_over), device=device, seed=seed,
        avg_d_log=average_log_degree(graphs)), cfg


def card_step_grads(initial, graphs, device, collate, cfg, params):
    """One step of a copy of `initial` on the card: the named gradients
    (float64 on the host) and the loss."""
    model = copy.deepcopy(initial)
    loss = float(Trainer(model, cfg).step(
        collate_graphs(graphs, **collate).to(device)))
    return {name: model.get_parameter(name).grad.double().cpu()
            for name in params}, loss


def lspe_twin_check(label, twin, served, grads, loss):
    """A COO run's served logits and card step against its dense twin's:
    logits within SLICE_TOL, loss within STEP_LOSS_RTOL, each gradient
    within STEP_GRAD_REL of the twin's largest entry."""
    want = twin["served"]
    np.testing.assert_allclose(served, want, **SLICE_TOL)
    rel = {n: float((g - twin["grads"][n]).abs().max())
           / float(twin["grads"][n].abs().max()) for n, g in grads.items()}
    loss_err = abs(loss - twin["loss"]) / abs(twin["loss"])
    print(f"lspe {label}: against its dense twin on the card: logits max "
          f"abs err {float(np.abs(served - want).max()):.3e}; step loss rel "
          f"err {loss_err:.2e}; grad max abs err / max |g| "
          + ", ".join(f"{n} {r:.2e}" for n, r in rel.items()), flush=True)
    if loss_err > STEP_LOSS_RTOL or max(rel.values()) > STEP_GRAD_REL:
        raise AssertionError(f"lspe {label}: off its dense twin: loss "
                             f"{loss_err}, grads {rel}")


def lspe_net(spec, device, card, twins, profile=False):
    """One net of the lspe phase, served and trained on the card; returns
    the launches of its requests and of its steps (all 0)."""
    label, config, model_arg, kw_over, _, per, nodes, coo, twin, params \
        = spec
    graphs, task, extra = lspe_graphs(spec, max(LPE_REQUESTS, 2) * per)
    t0 = time.perf_counter()
    model, cfg = lspe_build(spec, graphs, device, seed=0, transform=True)
    pe_s = time.perf_counter() - t0
    collate = dict(max_nodes=nodes, with_coo=coo, **extra)
    sizes = [g.num_nodes for g in graphs]
    print(f"lspe {label}: {type(model).__name__} from {config} "
          f"{'--model ' + model_arg if model_arg else ''}{kw_over or ''} "
          f"({sum(p.numel() for p in model.parameters())} parameters, "
          f"{len(model.layers)} layers); {len(graphs)} graphs of "
          f"{min(sizes)}-{max(sizes)} nodes padded to N={nodes}, batches of "
          f"{per}{', COO edges' if coo else ''}; host PE {pe_s:.2f} s",
          flush=True)
    calibrate_batch_norm(model, collate_graphs(graphs[:per], **collate),
                         device)
    pred = Predictor(model, device=device, max_batch=per,
                     collate_kwargs=collate, node_level=task == "node_clf")
    requests = [graphs[i * per:(i + 1) * per] for i in range(LPE_REQUESTS)]
    reset_launches()
    outs, call_ms = [], []
    for req in requests:
        t0 = time.perf_counter()
        outs.append(pred.predict(req))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    served = read_launches()
    if served != NONE:
        raise AssertionError(f"lspe {label}: launch counts {served}; these "
                             "nets run no TPU kernel")
    if not all(np.isfinite(np.asarray(o, np.float64)).all()
               for out in outs for o in out):
        raise AssertionError(f"lspe {label}: non-finite logits")
    first = outs[0]
    steady = statistics.median(call_ms[1:])
    print(f"lspe {label} serve: {LPE_REQUESTS} requests of {per} graphs; "
          f"ms/request {[round(t, 2) for t in call_ms]}, steady {steady:.2f}"
          f" ms = {per / steady * 1e3:.1f} graphs/s on {card}; launches "
          f"{served}", flush=True)
    lpe_ref_check(model, requests[0], outs[0], collate, f"lspe {label} serve")
    if profile:
        profile_call(f"one lspe {label} request of {per} graphs",
                     lambda: pred.predict(requests[0]))

    model, _ = lspe_build(spec, graphs, device, seed=1)
    initial = copy.deepcopy(model)
    batches = [collate_graphs(graphs[i * per:(i + 1) * per], **collate)
               .to(device) for i in range(2)]
    p = cfg["params"]
    steps = LPE_EPOCHS * len(batches)
    trainer_ = Trainer(model, TrainConfig(
        task=task, lr=p["init_lr"], weight_decay=p["weight_decay"],
        schedule="warmup", warmup_steps=steps, sign_flip=False, seed=0))
    reset_launches()
    losses, _ = timed_epochs(trainer_, batches, LPE_EPOCHS)
    more, window = timed_epochs(trainer_, batches, LPE_TIMED_EPOCHS)
    trained = read_launches()
    syncs = step_syncs(trainer_, batches[0])
    total = steps + LPE_TIMED_EPOCHS * len(batches)
    per_step = [r[0] / len(batches) for r in window]
    print(f"lspe {label} train: {total} AdamW steps of {per} graphs (warmup "
          f"towards lr {p['init_lr']}, weight decay {p['weight_decay']}, "
          f"dropout {cfg['net_params'].get('dropout', 0.0)}); epoch losses "
          f"{[round(x, 6) for x in losses + more]}; timed window "
          f"{sum(r[0] for r in window) / (len(window) * len(batches)):.2f} "
          f"ms/step (per epoch median {statistics.median(per_step):.2f}, "
          f"min {min(per_step):.2f}, max {max(per_step):.2f}) on {card}; "
          f"launches {trained}; host syncs in one step: {len(syncs)} "
          f"{syncs[:3]}", flush=True)
    if profile:
        profile_call(f"one lspe {label} training step of {per} graphs",
                     lambda: trainer_.step(batches[0]))
    if trained != NONE:
        raise AssertionError(f"lspe {label}: launch counts {trained}; these "
                             "nets run no TPU kernel")
    if not all(np.isfinite(losses + more)):
        raise AssertionError(f"lspe {label}: epoch losses {losses + more}")
    ref = graphs[:LPE_REF_GRAPHS]
    step_cfg = TrainConfig(task=task, sign_flip=False)
    step_parity(initial, ref, device, f"lspe {label} train", collate,
                step_cfg, params, rank=task == "node_clf")
    grads, loss = card_step_grads(initial, ref, device, collate, step_cfg,
                                  params)
    if twin is None:
        twins[label] = dict(served=first, grads=grads, loss=loss)
    else:
        lspe_twin_check(label, twins[twin], first, grads, loss)
    return [served, trained]


def lspe_slice(device, card, profile=False):
    """The lspe phase: each of LSPE_NETS served and trained; returns the
    launches of every run."""
    t0 = time.perf_counter()
    runs, twins = [], {}
    for spec in LSPE_NETS:
        runs += lspe_net(spec, device, card, twins, profile=profile)
    print(f"lspe phase: {len(LSPE_NETS)} runs of 5 nets in "
          f"{time.perf_counter() - t0:.1f} s on {card}", flush=True)
    return runs


def graphit_data():
    """The graphit phase's graphs: 2 batches of bench.py's ZINC data (as
    `make_zinc_graphs`) and one of 128 ogb_like_dataset molecules, each
    with its padded size."""
    t0 = time.perf_counter()
    zinc = zinc_like_dataset(seed=0, n_graphs=2 * ZINC_GRAPHS)
    DiffusionEncoding(beta=1.0).apply_to(zinc)
    LapEncoding(dim=ZINC_CFG["lap_pos_enc_dim"]).apply_to(zinc)
    mol = ogb_like_dataset(seed=0, n_graphs=MOLHIV_GRAPHS)
    print(f"graphit: host PE of {len(zinc)} ZINC-like graphs "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return {"zinc": (zinc, ZINC_NODES),
            "molhiv": (mol, max(g.num_nodes for g in mol))}


def first_output(out):
    """The logits of a model that returns them bare or first in a tuple."""
    return out[0] if isinstance(out, tuple) else out


def graphit_net(spec, data, device, card):
    """One model of GRAPHIT_NETS: GRAPHIT_REQUESTS requests of 128 graphs
    through Predictor with exact launches, the first GRAPHIT_REF_GRAPHS
    logits held to a float64 CPU forward; GRAPHIT_STEPS steps through
    Trainer with exact launches, finite losses and no host sync in one
    more; one step on 16 graphs held to a float64 CPU step. Returns the
    launches of the requests and of the steps."""
    label, cls, cfg, impl, kind, req_launches, step_launches, params = spec
    graphs, n_nodes = data[kind]
    collate = dict(max_nodes=n_nodes)
    request = graphs[:ZINC_GRAPHS]
    model = cls(**cfg, attention_impl=impl, seed=0, device=device)
    calibrate_batch_norm(model, collate_graphs(request, **collate), device)
    pred = Predictor(model, device=device, max_batch=len(request),
                     collate_kwargs=collate)
    reset_launches()
    outs, call_ms = [], []
    for _ in range(GRAPHIT_REQUESTS):
        t0 = time.perf_counter()
        outs.append(pred.predict(request))
        call_ms.append((time.perf_counter() - t0) * 1e3)
    served = read_launches()
    want = {k: GRAPHIT_REQUESTS * v for k, v in req_launches.items()}
    if served != want:
        raise AssertionError(f"graphit {label}: launch counts {served} for "
                             f"{GRAPHIT_REQUESTS} requests; expected "
                             f"{req_launches} each")
    shape = (len(request), 1) if kind == "zinc" else (len(request),)
    for out in outs:
        if out.shape != shape or not np.isfinite(out).all():
            raise AssertionError(f"graphit {label}: bad logits {out.shape}")
    ref_batch = collate_graphs(request[:GRAPHIT_REF_GRAPHS], **collate)
    with torch.inference_mode():
        ref = first_output(copy.deepcopy(model).to("cpu", torch.float64)(
            as_float64(ref_batch))).numpy()
        ref32 = first_output(copy.deepcopy(model).to("cpu")(
            ref_batch)).numpy()
    got = outs[0][:GRAPHIT_REF_GRAPHS]
    gap = lambda a: float(np.abs(a - ref).max())
    np.testing.assert_allclose(got, ref, **SLICE_TOL)

    task = "graph_reg" if kind == "zinc" else "binary_graph"
    train_model = cls(**cfg, attention_impl=impl, seed=1, device=device)
    initial = copy.deepcopy(train_model)
    batches = [collate_graphs(graphs[i:i + ZINC_GRAPHS], **collate)
               .to(device) for i in range(0, len(graphs), ZINC_GRAPHS)]
    trainer = Trainer(train_model, TrainConfig(
        task=task, lr=1e-3, weight_decay=1e-5, sign_flip=True, seed=0))
    reset_launches()
    losses, rows = timed_epochs(trainer, batches,
                                GRAPHIT_STEPS // len(batches))
    trained = read_launches()
    syncs = step_syncs(trainer, batches[0])
    per_step = [r[0] / len(batches) for r in rows]
    print(f"graphit {label} [{impl}]: {GRAPHIT_REQUESTS} requests of "
          f"{len(request)} graphs at N={n_nodes}, ms/call "
          f"{[round(t, 2) for t in call_ms]}, steady "
          f"{statistics.median(call_ms[1:]):.2f} ms/request; logits of "
          f"{GRAPHIT_REF_GRAPHS} graphs against float64 on the CPU: max abs "
          f"err CUDA {gap(got):.3e}, CPU float32 {gap(ref32):.3e} (max |y| "
          f"{float(np.abs(ref).max()):.3f}; tolerance rtol 1e-3 atol 1e-3); "
          f"{GRAPHIT_STEPS} steps ({task}, AdamW lr 1e-3) on {len(batches)} "
          f"batches: ms/step per epoch {[round(t, 2) for t in per_step]}, "
          f"median {statistics.median(per_step):.2f}; epoch losses "
          f"{[round(x, 6) for x in losses]}; host syncs in one more step: "
          f"{len(syncs)} {syncs[:3]}; launches a request "
          f"{ {k: v // GRAPHIT_REQUESTS for k, v in served.items() if v} }, "
          f"a step { {k: v // GRAPHIT_STEPS for k, v in trained.items() if v} }"
          f"; on {card}", flush=True)
    want = {k: GRAPHIT_STEPS * v for k, v in step_launches.items()}
    if trained != want:
        raise AssertionError(f"graphit {label}: launch counts {trained} for "
                             f"{GRAPHIT_STEPS} steps; expected "
                             f"{step_launches} each")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"graphit {label}: epoch losses {losses}")
    if syncs:
        raise AssertionError(f"graphit {label}: a training step syncs the "
                             f"host: {syncs}")
    step_parity(initial, graphs[:16], device, f"graphit {label} [{impl}]",
                collate, TrainConfig(task=task, regularization=0.1,
                                     sign_flip=False), params)
    return [served, trained]


def remat_check(data, device, card):
    """The FeTA ZINC model's step with `remat` against the same step
    without it, from the same weights on the same batch: the loss, every
    gradient, every updated weight and batch-norm statistic bit-equal, and
    exactly one more forward's launches (flash_fwd a layer, colstat twice
    for the filtered one). Returns the remat step's launches."""
    graphs, n_nodes = data["zinc"]
    batch = collate_graphs(graphs[:ZINC_GRAPHS], max_nodes=n_nodes).to(device)
    cfg = TrainConfig(task="graph_reg", lr=1e-3, weight_decay=1e-5,
                      sign_flip=False, seed=0)
    steps, launches = {}, {}
    for remat in (False, True):
        model = DiffGraphTransformerGenGCN(**ZINC_CFG, remat=remat, seed=2,
                                           device=device)
        trainer = Trainer(model, cfg)
        reset_launches()
        t0 = time.perf_counter()
        loss = trainer.step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches[remat] = read_launches()
        steps[remat] = (loss, model, ms)
    (l0, m0, ms0), (l1, m1, ms1) = steps[False], steps[True]
    differ = [n for (n, p0), p1 in zip(m0.named_parameters(),
                                       m1.parameters())
              if not (torch.equal(p0, p1) and torch.equal(p0.grad, p1.grad))]
    differ += [n for (n, b0), b1 in zip(m0.named_buffers(), m1.buffers())
               if not torch.equal(b0, b1)]
    extra = {k: launches[True][k] - launches[False][k] for k in NONE}
    print(f"graphit remat: one step of {ZINC_GRAPHS} graphs with and without "
          f"remat: loss {float(l1):.8f} / {float(l0):.8f}, bit-equal "
          f"{torch.equal(l0, l1)}; parameters, gradients and batch-norm "
          f"statistics differing {len(differ)} {differ[:4]}; extra launches "
          f"{ {k: v for k, v in extra.items() if v} }; {ms1:.2f} / "
          f"{ms0:.2f} ms (one step each, first of its model) on {card}",
          flush=True)
    if not torch.equal(l0, l1) or differ:
        raise AssertionError(f"graphit remat: the step differs ({differ})")
    if extra != {**NONE, "flash_fwd": ZINC_CFG["nb_layers"], "colstat": 2}:
        raise AssertionError(f"graphit remat: extra launches {extra}")
    return launches[True]


def expect_refusal(label, fn):
    """fn must raise ValueError: a route whose kernels do not take the
    shape refuses, it does not fall back."""
    try:
        fn()
    except ValueError as err:
        print(f"graphit {label}: refused ({str(err).splitlines()[0]})",
              flush=True)
        return
    raise AssertionError(f"graphit {label}: ran instead of refusing")


def graphit_slice(device, card):
    """The graphit phase: every model of GRAPHIT_NETS, the remat step's
    bit-equality, and the molhiv baseline's refusals at d_model 128 on
    "fused" and with head_fold; returns the launches of each run."""
    t0 = time.perf_counter()
    data = graphit_data()
    runs = []
    for spec in GRAPHIT_NETS:
        runs += graphit_net(spec, data, device, card)
    runs.append(remat_check(data, device, card))
    mol, n_mol = data["molhiv"]
    batch = collate_graphs(mol[:4], max_nodes=n_mol).to(device)
    for label, kw in (("molhiv fused", dict(attention_impl="fused")),
                      ("molhiv head_fold", dict(head_fold=True))):
        model = DiffGraphTransformerMolHiv(**MOLHIV_BASE_CFG, seed=0,
                                           device=device, **kw).eval()
        reset_launches()
        with torch.inference_mode():
            expect_refusal(label, lambda: model(batch))
        if any(read_launches().values()):
            raise AssertionError(f"graphit {label}: launched a kernel")
    print(f"graphit phase: {time.perf_counter() - t0:.1f} s", flush=True)
    return runs


def packed_request(model, batch, device):
    """One eval forward of a host batch: the copy to the card, the forward
    and the logits back on the host."""
    with torch.inference_mode():
        return model(batch.to(device))[0].cpu().numpy()


def packed_slice(device, card):
    """The packed phase: the ZINC regressor at ZINC_CFG's widths on
    ZINC_GRAPHS graphs packed into rows of PACKED_ROW nodes against the same
    graphs padded to ZINC_NODES on the "flash" route, the same weights:
    PACKED_REQUESTS eval forwards and PACKED_STEPS Trainer steps each, ms a
    request and a step side by side; no launch on the packed path (exact
    "flash" launches on the padded one), no host sync in a packed step;
    the packed logits, mapped back to the graphs, held to the padded
    model's on the card (PACKED_TOL) and to a float64 CPU forward
    (SLICE_TOL, the CPU float32 route's error beside); one packed step held
    to a float64 CPU step. Returns the launches of each run."""
    t0 = time.perf_counter()
    graphs = zinc_like_dataset(seed=0, n_graphs=ZINC_GRAPHS)
    DiffusionEncoding(beta=1.0).apply_to(graphs)
    LapEncoding(dim=ZINC_CFG["lap_pos_enc_dim"]).apply_to(graphs)
    rows = pack_rows([g.num_nodes for g in graphs], PACKED_ROW)
    batches = {"packed": pack_graphs(graphs, row_len=PACKED_ROW),
               "padded": collate_graphs(graphs, max_nodes=ZINC_NODES)}
    real = sum(g.num_nodes for g in graphs)
    print(f"packed: {len(graphs)} ZINC-like graphs ({real} nodes, host PE "
          f"{time.perf_counter() - t0:.2f} s) in {len(rows)} rows of "
          f"{PACKED_ROW} ({real / (len(rows) * PACKED_ROW):.1%} real, up to "
          f"{max(map(len, rows))} graphs a row) against {len(graphs)} rows "
          f"of {ZINC_NODES} ({real / (len(graphs) * ZINC_NODES):.1%} real)",
          flush=True)

    def in_graph_order(logits):
        out = np.zeros((len(graphs),) + logits.shape[2:], np.float32)
        for r, members in enumerate(rows):
            for slot, gi in enumerate(members):
                out[gi] = logits[r, slot]
        return out

    padded = DiffGraphTransformerGenGCN(**ZINC_CFG, attention_impl="flash",
                                        seed=0, device=device)
    calibrate_batch_norm(padded, batches["padded"], device)
    models = {"packed": PackedDiffGraphTransformerGenGCN(
        **ZINC_CFG, seed=0, device=device), "padded": padded}
    models["packed"].load_state_dict(padded.state_dict())
    models["packed"].eval()
    runs, served, ms = [], {}, {}
    want = {"packed": NONE, "padded": {
        k: PACKED_REQUESTS * v
        for k, v in ZINC_REQUEST_LAUNCHES["flash"].items()}}
    for label, model in models.items():
        reset_launches()
        call_ms = []
        for _ in range(PACKED_REQUESTS):
            t1 = time.perf_counter()
            served[label] = packed_request(model, batches[label], device)
            call_ms.append((time.perf_counter() - t1) * 1e3)
        launches = read_launches()
        runs.append(launches)
        ms[label] = call_ms
        if launches != want[label]:
            raise AssertionError(f"packed {label}: launches {launches} for "
                                 f"{PACKED_REQUESTS} requests; expected "
                                 f"{want[label]}")
    got = in_graph_order(served["packed"])
    if not np.isfinite(got).all():
        raise AssertionError("packed: non-finite logits")
    gap = lambda a, b: float(np.abs(a - b).max())
    np.testing.assert_allclose(got, served["padded"], **PACKED_TOL)
    cpu = copy.deepcopy(models["packed"]).to("cpu")
    with torch.inference_mode():
        ref32 = in_graph_order(cpu(batches["packed"])[0].numpy())
        ref = in_graph_order(cpu.to(torch.float64)(
            as_float64(batches["packed"]))[0].numpy())
    np.testing.assert_allclose(got, ref, **SLICE_TOL)
    print(f"packed serve: {PACKED_REQUESTS} requests of {len(graphs)} "
          f"graphs, ms/request packed "
          f"{[round(t, 2) for t in ms['packed']]} (median "
          f"{statistics.median(ms['packed'][1:]):.2f} after the first), "
          f"padded flash {[round(t, 2) for t in ms['padded']]} (median "
          f"{statistics.median(ms['padded'][1:]):.2f}); launches packed "
          f"{ {k: v for k, v in runs[0].items() if v} }, padded "
          f"{ {k: v // PACKED_REQUESTS for k, v in runs[1].items() if v} } a "
          f"request; logits of {len(graphs)} graphs: packed vs padded on the "
          f"card max abs err {gap(got, served['padded']):.3e} (tolerance "
          f"rtol 1e-4 atol 1e-4), against float64 on the CPU CUDA "
          f"{gap(got, ref):.3e}, CPU float32 {gap(ref32, ref):.3e} (max |y| "
          f"{float(np.abs(ref).max()):.3f}; tolerance rtol 1e-3 atol 1e-3); "
          f"on {card}", flush=True)

    cfg = TrainConfig(task="graph_reg", lr=1e-3, weight_decay=1e-5,
                      sign_flip=True, seed=0)
    initial = None
    step = {}
    for label in ("packed", "padded"):
        model = (PackedDiffGraphTransformerGenGCN(**ZINC_CFG, seed=1,
                                                  device=device)
                 if label == "packed" else DiffGraphTransformerGenGCN(
                     **ZINC_CFG, attention_impl="flash", seed=1,
                     device=device))
        if label == "packed":
            initial = copy.deepcopy(model)
        batch = batches[label].to(device)
        trainer = Trainer(model, cfg)
        reset_launches()
        losses, window = timed_epochs(trainer, [batch], PACKED_STEPS)
        launches = read_launches()
        runs.append(launches)
        syncs = step_syncs(trainer, batch)
        step[label] = [r[0] for r in window]
        expect = (NONE if label == "packed" else {
            k: PACKED_STEPS * v
            for k, v in ZINC_STEP_LAUNCHES["flash"].items()})
        print(f"packed train [{label}]: {PACKED_STEPS} steps of "
              f"{len(graphs)} graphs in {batch.x.shape[0]} rows of "
              f"{batch.x.shape[1]} (L1, AdamW lr 1e-3, sign flip on): "
              f"ms/step {[round(t, 2) for t in step[label]]}, median "
              f"{statistics.median(step[label][1:]):.2f} after the first; "
              f"losses {[round(x, 6) for x in losses]}; launches "
              f"{ {k: v for k, v in launches.items() if v} }; host syncs in "
              f"one more step: {len(syncs)} {syncs[:3]}; on {card}",
              flush=True)
        if launches != expect:
            raise AssertionError(f"packed train [{label}]: launches "
                                 f"{launches}; expected {expect}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"packed train [{label}]: losses {losses}")
        if syncs:
            raise AssertionError(f"packed train [{label}]: a step syncs the "
                                 f"host: {syncs}")
    print(f"packed against padded (flash) at B={len(graphs)} graphs: "
          f"ms/request {statistics.median(ms['packed'][1:]):.2f} / "
          f"{statistics.median(ms['padded'][1:]):.2f}, ms/step "
          f"{statistics.median(step['packed'][1:]):.2f} / "
          f"{statistics.median(step['padded'][1:]):.2f}; on {card}",
          flush=True)
    step_parity(initial, graphs[:PACKED_STEP_GRAPHS], device, "packed step",
                lambda gs: pack_graphs(gs, row_len=PACKED_ROW),
                TrainConfig(task="graph_reg", regularization=0.1,
                            sign_flip=False), STEP_PARAMS)
    return runs


def gckn_encode(model, graphs, batch, device, dtype=torch.float32):
    """(codes [nodes, 32], ms, peak MiB) of one encode on `device`."""
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    codes = np.concatenate(model.encode(graphs, batch, device=device,
                                        dtype=dtype))
    ms = (time.perf_counter() - t0) * 1e3
    peak = (torch.cuda.max_memory_allocated() / 2 ** 20
            if device.type == "cuda" else float("nan"))
    return codes, ms, peak


def gckn_supervised_check(graphs, device, card):
    """GCKNSupervised at gckn_sup.py's defaults on the first 80 % of
    `graphs`: k-means init, GCKN_SUP_STEPS Adam steps (L1) on the card
    with finite losses and no kernel launched; its first step's loss and
    gradients (two runs bit-equal) held to a float64 step on the card
    (loss rtol STEP_LOSS_RTOL, gradients STEP_GRAD_REL of their largest
    entry, or of 1e-3 of the largest of all). Returns the launches."""
    tr = graphs[: int(0.8 * len(graphs))]
    t0 = time.perf_counter()
    model = GCKNSupervised(28, [32], [4], 1, kernel_args=0.5, pooling="sum",
                           seed=0, device=device)
    model.unsup_init(tr, GCKN_SUP_SAMPLES, seed=0)
    batch = build_path_batch(tr, 4)
    init_s = time.perf_counter() - t0
    y = torch.tensor([float(g.y) for g in tr], device=device)
    initial = copy.deepcopy(model)

    def first_step(dtype):
        m = copy.deepcopy(initial).to(dtype=dtype)
        loss = torch.abs(m(batch)[:, 0] - y.to(dtype)).mean()
        loss.backward()
        return loss.item(), {n: p.grad.double().cpu()
                             for n, p in m.named_parameters()}

    (l32, g32), (l32b, g32b), (l64, g64) = (
        first_step(torch.float32), first_step(torch.float32),
        first_step(torch.float64))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    reset_launches()
    losses, step_ms = [], []
    for _ in range(GCKN_SUP_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt.zero_grad()
        loss = torch.abs(model(batch)[:, 0] - y).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
        step_ms.append((time.perf_counter() - t1) * 1e3)
    launches = read_launches()
    # a parameter whose float64 gradient is below 1e-3 of the largest
    # (the biases when the L1 residuals' signs balance) is held to that
    floor = 1e-3 * max(float(g.abs().max()) for g in g64.values())
    rel = {n: float((g32[n] - g).abs().max()) / max(float(g.abs().max()),
                                                    floor)
           for n, g in g64.items()}
    loss_err = abs(l32 - l64) / abs(l64)
    bits = all(torch.equal(g32[n], g32b[n]) for n in g32) and l32 == l32b
    print(f"gckn supervised: {len(tr)} graphs, {batch.path_indices[3].shape[0]}"
          f" paths of 4 nodes, k-means init over {GCKN_SUP_SAMPLES} paths "
          f"{init_s:.2f} s; {GCKN_SUP_STEPS} Adam steps (L1, lr 1e-3): ms "
          f"{[round(t, 2) for t in step_ms]}, losses "
          f"{[round(x, 6) for x in losses]}; first step against float64 on "
          f"the card: loss {l32:.8f} vs {l64:.8f} (rel {loss_err:.2e}), "
          f"grad max abs err / max |g| "
          + ", ".join(f"{n} {r:.2e}" for n, r in rel.items())
          + f"; two float32 steps bit-equal {bits}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; on {card}",
          flush=True)
    if not all(np.isfinite(losses)) or launches != NONE:
        raise AssertionError(f"gckn supervised: losses {losses}, launches "
                             f"{launches}")
    if loss_err > STEP_LOSS_RTOL or max(rel.values()) > STEP_GRAD_REL \
            or not bits:
        raise AssertionError(f"gckn supervised: step off float64 (loss "
                             f"{loss_err:.2e}, grads {rel}) or not "
                             f"repeatable ({bits})")
    return launches


def gckn_slice(device, card):
    """The gckn phase (GCKN_* above): enumeration and path batch, k-means
    and the encode timed; the codes twice bit-equal, held to float64 and
    to the CPU; the FeTA + GCKN regressor served and trained on "flash"
    with exact launches; GCKNSupervised stepped. Returns the launches."""
    graphs = zinc_like_dataset(seed=0, n_graphs=GCKN_GRAPHS)
    cpu = torch.device("cpu")
    k = GCKN_PE["path_size"]
    t0 = time.perf_counter()
    batch = build_path_batch(graphs, k)
    enum_s = time.perf_counter() - t0
    real = sum(int(m.sum()) for m in batch.path_mask)
    held = sum(p.nbytes for p in batch.path_indices) / 2 ** 20
    model = GCKNFeature.create(28, [GCKN_PE["dim"]], [k],
                               GCKN_PE["kernel_arg"],
                               pooling=GCKN_PE["pooling"], seed=0)
    t0 = time.perf_counter()
    paths = sample_paths(model.layers[0], batch.features, batch,
                         GCKN_PE["n_sampling_paths"], seed=0)
    model.layers[0] = unsup_train_layer(model.layers[0], paths, seed=0)
    kmeans_s = time.perf_counter() - t0
    codes, first_ms, peak = gckn_encode(model, graphs, batch, device)
    again, ms, peak2 = gckn_encode(model, graphs, batch, device)
    c64, ms64, _ = gckn_encode(model, graphs, batch, device, torch.float64)
    sub = graphs[:GCKN_CPU_GRAPHS]
    sub_batch = build_path_batch(sub, k)
    sub_card, _, _ = gckn_encode(model, sub, sub_batch, device)
    sub_cpu, cpu_ms, _ = gckn_encode(model, sub, sub_batch, cpu)
    scale = float(np.abs(c64).max())
    err64 = float(np.abs(codes - c64).max()) / scale
    sub_scale = float(np.abs(sub_cpu).max())
    err_cpu = float(np.abs(sub_card - sub_cpu).max()) / sub_scale
    n_nodes = sum(g.num_nodes for g in graphs)
    print(f"gckn: {len(graphs)} ZINC-like graphs ({n_nodes} nodes), paths "
          f"of 1-{k} nodes: {real} ({batch.path_mask[k - 1].sum()} of {k} "
          f"nodes), enumerated (native, built from native/pathenum.cpp) "
          f"and batched in {enum_s:.2f} s on the host, {held:.0f} MiB of "
          f"path indices; k-means ({GCKN_PE['dim']} anchors over "
          f"{paths.shape[0]} sampled paths, numpy) {kmeans_s:.2f} s on the "
          f"host; encode on the card {first_ms:.1f} ms (paths uploaded), "
          f"{ms:.1f} ms again, float64 {ms64:.1f} ms; peak device memory "
          f"{peak:.0f} / {peak2:.0f} MiB; two encodes bit-equal "
          f"{np.array_equal(codes, again)}; max abs err / max |code| "
          f"({scale:.3f}) against float64 on the card {err64:.2e}, on "
          f"{GCKN_CPU_GRAPHS} graphs against the CPU's float32 encode "
          f"({cpu_ms:.0f} ms) {err_cpu:.2e} (tolerance {GCKN_TOL}); on "
          f"{card}", flush=True)
    if not np.array_equal(codes, again):
        raise AssertionError("gckn: two encodes on the card differ")
    if not (err64 <= GCKN_TOL and err_cpu <= GCKN_TOL):
        raise AssertionError(f"gckn: codes off float64 ({err64:.2e}) or "
                             f"the CPU ({err_cpu:.2e})")
    attach_codes(graphs, [codes[o - g.num_nodes:o] for g, o in zip(
        graphs, np.cumsum([g.num_nodes for g in graphs]))])

    net = DiffGraphTransformerGenGCN(**GCKN_CFG, attention_impl="flash",
                                     seed=0, device=device)
    collate = dict(max_nodes=ZINC_NODES)
    calibrate_batch_norm(net, collate_graphs(graphs, **collate), device)
    pred = Predictor(net, device=device, collate_kwargs=collate,
                     max_batch=GCKN_GRAPHS)
    runs = []
    reset_launches()
    t0 = time.perf_counter()
    served = pred.predict(graphs)
    serve_ms = (time.perf_counter() - t0) * 1e3
    runs.append(read_launches())
    if runs[-1] != ZINC_REQUEST_LAUNCHES["flash"]:
        raise AssertionError(f"gckn serve: launches {runs[-1]}")
    ref_b = collate_graphs(graphs[:8], **collate)
    with torch.inference_mode():
        ref = copy.deepcopy(net).to("cpu", torch.float64)(
            as_float64(ref_b))[0].numpy()
        ref32 = copy.deepcopy(net).to("cpu")(ref_b)[0].numpy()
    gap = lambda a: float(np.abs(a - ref).max())
    print(f"gckn serve: one request of {len(graphs)} graphs (lap-PE = GCKN "
          f"codes, dim {GCKN_PE['dim']}) at N={ZINC_NODES} on \"flash\" "
          f"{serve_ms:.2f} ms; launches "
          f"{ {k: v for k, v in runs[-1].items() if v} }; logits of 8 "
          f"graphs against float64 on the CPU: CUDA {gap(served[:8]):.3e}, "
          f"CPU float32 {gap(ref32):.3e} (max |y| "
          f"{float(np.abs(ref).max()):.3f}; tolerance rtol 1e-3 atol 1e-3);"
          f" on {card}", flush=True)
    np.testing.assert_allclose(served[:8], ref, **SLICE_TOL)

    model = DiffGraphTransformerGenGCN(**GCKN_CFG, attention_impl="flash",
                                       seed=1, device=device)
    initial = copy.deepcopy(model)
    trainer = Trainer(model, TrainConfig(
        task="graph_reg", lr=1e-3, weight_decay=1e-4, schedule="plateau",
        plateau_patience=15, plateau_factor=0.5, min_lr=1e-5,
        sign_flip=False, seed=0))
    train_b = collate_graphs(graphs, **collate).to(device)
    reset_launches()
    losses, window = timed_epochs(trainer, [train_b], GCKN_STEPS)
    runs.append(read_launches())
    want = {k: GCKN_STEPS * v for k, v in ZINC_STEP_LAUNCHES["flash"].items()}
    print(f"gckn train: {GCKN_STEPS} steps of {len(graphs)} graphs (L1, "
          f"AdamW lr 1e-3, plateau schedule) ms/step "
          f"{[round(r[0], 2) for r in window]}; losses "
          f"{[round(x, 6) for x in losses]}; launches "
          f"{ {k: v for k, v in runs[-1].items() if v} }; on {card}",
          flush=True)
    if runs[-1] != want or not all(np.isfinite(losses)):
        raise AssertionError(f"gckn train: launches {runs[-1]} (expected "
                             f"{want}), losses {losses}")
    step_parity(initial, graphs[:16], device, "gckn train", collate,
                TrainConfig(task="graph_reg", regularization=0.1,
                            sign_flip=False), STEP_PARAMS)
    runs.append(gckn_supervised_check(
        zinc_like_dataset(seed=0, n_graphs=GCKN_SUP_GRAPHS), device, card))
    return runs


@contextlib.contextmanager
def entry_point_tally():
    """Count the launches of the unfolded flash kernels, colstat, the
    fused pair and the fused MLP pair by C entry point, {(wrapper, dtype
    suffix): launches} (suffix "" float32, "_bf16", "_bf16_f32pe";
    `common.dtype_suffix`): each launch looks its entry point up once
    (`_kernel`), and a CPU tensor none."""
    tally = collections.Counter()
    saved = (fl_mod._kernel, cs_mod._kernel, fa_mod._kernel, fm_mod._kernel)
    fl_kernel, cs_kernel, fa_kernel, fm_kernel = saved

    def fl(name, suffix=""):
        tally[name, suffix] += 1
        return fl_kernel(name, suffix)

    def cs(suffix=""):
        tally["colstat", suffix] += 1
        return cs_kernel(suffix)

    def fa(name, suffix=""):
        tally[f"fused_attn_{name}", suffix] += 1
        return fa_kernel(name, suffix)

    def fm(name, suffix=""):
        if name in ("fwd", "bwd"):            # not the grid's helpers
            tally[f"fused_mlp_{name}", suffix] += 1
        return fm_kernel(name, suffix)

    fl_mod._kernel, cs_mod._kernel, fa_mod._kernel, fm_mod._kernel = \
        fl, cs, fa, fm
    try:
        yield tally
    finally:
        fl_mod._kernel, cs_mod._kernel, fa_mod._kernel, fm_mod._kernel = \
            saved


def check_tally(label, tally, want):
    """The entry-point tally against {(wrapper, suffix): launches}."""
    got = {k: v for k, v in tally.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{label}: entry points {got}, expected {want}")


def policy_launches(launches, suffix, kernels=FLASH_ROUTE):
    """{(wrapper, suffix): n} of a run's launches of `kernels` (the
    flash route's by default)."""
    return {(k, suffix): launches[k] for k in kernels}


def bf16_step_parity(initial, graphs, device, label, collate, cfg, params):
    """One step from the same weights under the bf16 policy on the card and
    on the CPU (the plain bf16 route), and in float64 on the CPU with it
    unset: the card's loss error and each named gradient's (max abs err /
    max |g| of the float64 step) within BF16_MODEL_FACTOR of the CPU bf16
    route's."""
    loss, rel, scale, secs = step_errors(initial, graphs, device, collate,
                                         cfg, params, policy="bfloat16")
    err = {r: abs(loss[r] - loss["cpu64"]) / abs(loss["cpu64"])
           for r in ("cuda", "cpu32")}
    bad = [n for n in params
           if rel["cuda"][n] > BF16_MODEL_FACTOR * rel["cpu32"][n]]
    print(f"{label}: one step on {len(graphs)} graphs under the bf16 policy "
          f"from the initial weights; loss cuda {loss['cuda']:.6f}, cpu bf16 "
          f"{loss['cpu32']:.6f}, cpu64 (policy off) {loss['cpu64']:.6f} (rel "
          f"err cuda {err['cuda']:.2e}, cpu bf16 {err['cpu32']:.2e}); grad max "
          f"abs err / max |g| against cpu64: " + "; ".join(
              f"{n} (max |g| {scale[n]:.3e}): cuda {rel['cuda'][n]:.2e}, cpu "
              f"bf16 {rel['cpu32'][n]:.2e}" for n in params)
          + f" (tolerance: {BF16_MODEL_FACTOR}x the CPU bf16 route's; CPU "
          f"steps {secs['cpu32']:.1f} s bf16, {secs['cpu64']:.1f} s f64)",
          flush=True)
    if err["cuda"] > BF16_MODEL_FACTOR * err["cpu32"]:
        raise AssertionError(f"{label}: bf16 step loss {loss}")
    if bad:
        raise AssertionError(f"{label}: bf16 gradients off float64: {bad}")


@contextlib.contextmanager
def policy_env(compute, modulation):
    """FETA_COMPUTE_DTYPE and FETA_BF16_MODULATION set inside (None:
    unset), as they were after."""
    values = {"FETA_COMPUTE_DTYPE": compute,
              "FETA_BF16_MODULATION": modulation}
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bf16_route_check(initial, graphs, device, label, collate,
                     params=BF16_ROUTE_PARAMS, routes=BF16_ROUTES,
                     suffix=None):
    """The card under each bf16 route of BF16_ROUTES against the CPU plain
    version of that route, from the same weights (`initial`, its batch
    norms calibrated) on the same graphs: the eval-mode logits at the real
    nodes (max abs difference), and the named gradients of the train-mode
    logits against a seeded cotangent (max abs difference over the CPU
    route's max |g|; a smooth function of the logits, where a step's L1
    loss flips sign with a rounding). Each at most BF16_ROUTE_FACTOR times
    the larger of the CPU route's distances from the other two CPU routes
    (the other bf16 route, float32), and the card's flash launches all
    through the route's entry points (`_bf16`, `_bf16_f32pe`: what tells
    the route, as the numbers cannot: BF16_ROUTES' note). `routes` and
    `suffix` ({bf16 route: entry point suffix}) for a path whose kernels
    take pe and deg float32 whatever FETA_BF16_MODULATION says (the fused
    pair, the fused MLP): one bf16 route, and float32. Prints every
    distance."""
    batch = collate_graphs(graphs, **collate)
    suffix = suffix or {"bf16": "_bf16", "bf16 pe f32": "_bf16_f32pe"}

    def run(route, dev):
        model = copy.deepcopy(initial).to(dev)
        b = batch.to(dev)
        with policy_env(*routes[route]):
            model.eval()
            with torch.inference_mode():
                out = first_output(model(b)).float()
            model.train()
            y = first_output(model(b)).float()
            cot = torch.randn(y.shape, generator=torch.Generator()
                              .manual_seed(len(graphs))).to(dev)
            if y.dim() == 3:                     # node level: real nodes
                out, cot = out[b.node_mask], cot * b.node_mask[..., None]
            (y * cot).sum().backward()
        got = {"logits": out.double().cpu()}
        for n in params:
            got[n] = model.get_parameter(n).grad.double().cpu()
        return got

    cpu = {r: run(r, "cpu") for r in routes}
    keys = ["logits", *params]

    def dist(a, b, k):
        d = float((a[k] - b[k]).abs().max())
        return d / float(b[k].abs().max()) if k in params else d

    lines, bad = [], []
    for route in suffix:
        with entry_point_tally() as tally:
            card = run(route, device)
        if {s for _, s in tally} != {suffix[route]}:
            raise AssertionError(f"{label} [{route}]: entry points "
                                 f"{dict(tally)}")
        others = [r for r in routes if r != route]
        text = []
        for k in keys:
            d_card = dist(card, cpu[route], k)
            d_cpu = [dist(cpu[r], cpu[route], k) for r in others]
            text.append(f"{k} {d_card:.3e} / " + " ".join(
                f"{d:.3e}" for d in d_cpu))
            if not d_card <= BF16_ROUTE_FACTOR * max(d_cpu):
                bad.append((route, k, d_card, d_cpu))
        lines.append(f"[{route}, entry points {dict(tally)}] "
                     + ", ".join(text))
    print(f"{label}: {len(graphs)} graphs at {BF16_ROUTE_LAYERS} layers, "
          f"the card against the CPU plain version of its bf16 route / that "
          f"CPU route against the other bf16 one and against float32, "
          f"logits max abs, gradients against a seeded cotangent max abs "
          f"over max |g|: " + "; ".join(lines)
          + f" (tolerance: {BF16_ROUTE_FACTOR}x the larger CPU distance)",
          flush=True)
    if bad:
        raise AssertionError(f"{label}: the card's bf16 run is further "
                             f"from its CPU route than {BF16_ROUTE_FACTOR}x "
                             f"the CPU routes' spread: {bad}")


def bf16_route_sbm(graphs, device):
    """`bf16_route_check` on the SBM model at BF16_ROUTE_LAYERS layers and
    MODEL_CFG's widths, on the first two graphs."""
    model = DiffGraphTransformerGenGCNSBM(
        **dict(MODEL_CFG, nb_layers=BF16_ROUTE_LAYERS), seed=0,
        device=device)
    collate = {"max_nodes": N_NODES, "node_labels": True}
    calibrate_batch_norm(model, collate_graphs(graphs[:2], **collate),
                         device)
    bf16_route_check(model, graphs[:2], device, "bf16 route sbm", collate)


def bf16_route_zinc(graphs, device):
    """`bf16_route_check` on the ZINC regressor at BF16_ROUTE_LAYERS layers
    and ZINC_CFG's widths on "flash", on 16 graphs."""
    model = DiffGraphTransformerGenGCN(
        **dict(ZINC_CFG, nb_layers=BF16_ROUTE_LAYERS),
        attention_impl="flash", seed=1, device=device)
    collate = {"max_nodes": ZINC_NODES}
    calibrate_batch_norm(model, collate_graphs(graphs[:16], **collate),
                         device)
    bf16_route_check(model, graphs[:16], device, "bf16 route zinc [flash]",
                     collate)


def bf16_sbm(graphs, device, card):
    """The bf16 phase on the SBM node classifier at N=1024
    (DiffGraphTransformerGenGCNSBM at MODEL_CFG): served and trained under
    the policy and with it unset on the same weights, in turns (the order
    alternating round by round), the launches counted exactly by wrapper
    and by entry point; graph 0's served logits off a float64 CPU forward
    within BF16_MODEL_FACTOR of the CPU bf16 route's error (a step is held
    so on the ZINC model, `bf16_zinc`: at N=1024 the CPU steps take ~20
    s). Returns the launches and the medians {policy: (ms a request, ms a
    step)}."""
    policies = {"bf16": "bfloat16", "f32": None}
    suffix = {"bf16": "_bf16", "f32": ""}
    order = lambda r: list(policies)[::1 if r % 2 == 0 else -1]
    model = DiffGraphTransformerGenGCNSBM(**MODEL_CFG, seed=0, device=device)
    collate = {"max_nodes": N_NODES, "node_labels": True}
    calibrate_batch_norm(model, collate_graphs(graphs, **collate), device)
    cpu_model = copy.deepcopy(model).to("cpu")
    pred = Predictor(model, device=device, max_batch=N_GRAPHS,
                     collate_kwargs=collate, node_level=True)
    runs, ms, outs = [], {p: [] for p in policies}, {}
    with entry_point_tally() as tally:
        for r in range(BF16_SBM_ROUNDS):
            for p in order(r):
                with compute_dtype_env(policies[p]):
                    reset_launches()
                    t0 = time.perf_counter()
                    out = pred.predict(graphs)
                    ms[p].append((time.perf_counter() - t0) * 1e3)
                    launches = read_launches()
                if launches != {**NONE, "colstat": 2,
                                 "flash_fwd": MODEL_CFG["nb_layers"]}:
                    raise AssertionError(f"bf16 sbm serve [{p}]: launches "
                                         f"{launches}")
                runs.append(launches)
                outs.setdefault(p, out)
    check_tally("bf16 sbm serve", tally, {
        (k, suffix[p]): BF16_SBM_ROUNDS * n for p in policies
        for k, n in (("flash_fwd", MODEL_CFG["nb_layers"]), ("colstat", 2))})
    n0 = graphs[0].num_nodes
    one = collate_graphs(graphs[:1], **collate)
    with torch.inference_mode():
        ref = copy.deepcopy(cpu_model).to(torch.float64)(
            as_float64(one))[0][0, :n0].numpy()
        with compute_dtype_env("bfloat16"):
            cpu_bf16 = cpu_model(one)[0][0, :n0].numpy()
    gap = lambda a: float(np.abs(a - ref).max())
    err = {p: gap(outs[p][0]) for p in policies}
    err_cpu = gap(cpu_bf16)
    if not all(np.isfinite(o).all() for out in outs.values() for o in out):
        raise AssertionError("bf16 sbm serve: non-finite logits")
    print(f"bf16 sbm serve: {BF16_SBM_ROUNDS} requests of {N_GRAPHS} graphs "
          f"at N={N_NODES} under each policy in turns; ms/request bf16 "
          f"{[round(t, 2) for t in ms['bf16']]}, f32 "
          f"{[round(t, 2) for t in ms['f32']]}; launches "
          f"{MODEL_CFG['nb_layers']} flash_fwd + 2 colstat a request, by "
          f"entry point {dict(tally)}; graph 0's "
          f"logits off the float64 CPU forward: cuda bf16 {err['bf16']:.3e} "
          f"(at most {BF16_MODEL_FACTOR}x the CPU bf16 route's {err_cpu:.3e}), "
          f"cuda f32 {err['f32']:.3e}; max |logit| "
          f"{float(np.abs(ref).max()):.3f}; on {card}", flush=True)
    if err["bf16"] > BF16_MODEL_FACTOR * err_cpu:
        raise AssertionError(f"bf16 sbm serve: logits {err}, cpu {err_cpu}")

    model = DiffGraphTransformerGenGCNSBM(**MODEL_CFG, seed=1, device=device)
    initial = copy.deepcopy(model)
    per = N_GRAPHS // 2
    batches = [collate_graphs(graphs[i:i + per], **collate).to(device)
               for i in range(0, N_GRAPHS, per)]
    steps = BF16_SBM_EPOCHS * len(batches)
    trainers = {p: Trainer(copy.deepcopy(initial), TrainConfig(
        lr=1e-3, weight_decay=1e-5, sign_flip=True, seed=0,
        schedule="warmup", warmup_steps=steps)) for p in policies}
    step_ms, losses = {p: [] for p in policies}, {p: [] for p in policies}
    with entry_point_tally() as tally:
        for r in range(BF16_SBM_EPOCHS):
            for p in order(r):
                with compute_dtype_env(policies[p]):
                    reset_launches()
                    loss, rows = timed_epochs(trainers[p], batches, 1)
                    launches = read_launches()
                want = {k: len(batches) * v for k, v in STEP_LAUNCHES.items()}
                if launches != want:
                    raise AssertionError(f"bf16 sbm train [{p}]: launches "
                                         f"{launches}, expected {want}")
                runs.append(launches)
                losses[p] += loss
                if r:                          # the first epoch warms up
                    step_ms[p].append(rows[0][0] / len(batches))
    check_tally("bf16 sbm train", tally, {
        (k, suffix[p]): steps * STEP_LAUNCHES[k] for p in policies
        for k in FLASH_ROUTE})
    print(f"bf16 sbm train: {BF16_SBM_EPOCHS} epochs of {len(batches)} steps "
          f"of {per} graphs at N={N_NODES} under each policy in turns (the "
          f"first a warm-up; warmup lr as the train phase); ms/step bf16 "
          f"{[round(t, 2) for t in step_ms['bf16']]}, f32 "
          f"{[round(t, 2) for t in step_ms['f32']]}; epoch losses bf16 "
          f"{[round(x, 6) for x in losses['bf16']]}, f32 "
          f"{[round(x, 6) for x in losses['f32']]}; launches "
          f"{STEP_LAUNCHES} a step, by entry point {dict(tally)}; on {card}",
          flush=True)
    if not all(np.isfinite(losses["bf16"] + losses["f32"])):
        raise AssertionError(f"bf16 sbm train: losses {losses}")
    med = lambda v: statistics.median(v)
    return runs, {p: (med(ms[p]), med(step_ms[p])) for p in policies}


def bf16_policy_net(label, build, graphs, per, collate, device, card,
                    task, serve_want, step_want, step_cfg, params,
                    train_cfg, n_ref):
    """One model of the bf16 phase's fused paths (the fused pair, the
    fused MLP pair), served and trained under the bf16 policy and with it
    unset on the same weights, in turns (BF16_NET_ROUNDS rounds of one
    request of `per` graphs and one step on them, the order alternating):
    each run's launches exact by wrapper ({wrapper: launches} a request
    and a step, `serve_want` / `step_want`) and by C entry point (`_bf16`
    under the policy, float32 without; the modulation kernel, float32 on
    both, is not among the entry points tallied); the first `n_ref`
    served graphs' bf16 logits off a float64 CPU forward within
    BF16_MODEL_FACTOR of the CPU plain bf16 route's error; finite losses;
    then one step from the initial weights held to float64 within
    BF16_MODEL_FACTOR of the CPU bf16 route's error
    (`bf16_step_parity`). After the rounds, with both policies warm,
    BF16_NET_TIMED_REQUESTS requests and BF16_NET_TIMED_STEPS steps under
    each policy in turns (host clock; each ends in a copy to the host),
    printed as medians and quartiles. `build(seed)` makes the model on
    the card. Returns the launches of every run."""
    policies = {"bf16": "bfloat16", "f32": None}
    suffix = {"bf16": "_bf16", "f32": ""}
    order = lambda r: list(policies)[::1 if r % 2 == 0 else -1]
    node_level = task == "node_clf"
    model = build(0)
    calibrate_batch_norm(model, collate_graphs(graphs[:per], **collate),
                         device)
    cpu_model = copy.deepcopy(model).to("cpu")
    pred = Predictor(model, device=device, max_batch=per,
                     collate_kwargs=collate, node_level=node_level)
    request = graphs[:per]
    initial = build(1)
    batch = collate_graphs(request, **collate).to(device)
    trainers = {p: Trainer(copy.deepcopy(initial), train_cfg)
                for p in policies}
    runs, outs, losses = [], {}, []
    with entry_point_tally() as tally:
        for r in range(BF16_NET_ROUNDS):
            for p in order(r):
                with compute_dtype_env(policies[p]):
                    reset_launches()
                    outs.setdefault(p, pred.predict(request))
                    served = read_launches()
                    reset_launches()
                    losses.append(float(trainers[p].step(batch)))
                    trained = read_launches()
                for got, want, what in ((served, serve_want, "request"),
                                        (trained, step_want, "step")):
                    if got != {**NONE, **want}:
                        raise AssertionError(f"{label} [{p}] {what}: "
                                             f"launches {got}, expected "
                                             f"{want}")
                runs += [served, trained]
    check_tally(label, tally, {
        (k, suffix[p]): BF16_NET_ROUNDS * (serve_want.get(k, 0)
                                           + step_want.get(k, 0))
        for p in policies for k in set(serve_want) | set(step_want)
        if k not in ("modulation_fwd", "modulation_bwd")})
    ms = {(p, what): [] for p in policies for what in ("request", "step")}
    for what, n, fn in (
            ("request", BF16_NET_TIMED_REQUESTS,
             lambda p: pred.predict(request)),
            ("step", BF16_NET_TIMED_STEPS,
             lambda p: float(trainers[p].step(batch)))):
        for r in range(n):
            for p in order(r):
                with compute_dtype_env(policies[p]):
                    t0 = time.perf_counter()
                    fn(p)
                    ms[p, what].append((time.perf_counter() - t0) * 1e3)
    quart = lambda v: "/".join(f"{q:.2f}" for q in statistics.quantiles(
        v, n=4))
    ratio = lambda what: (statistics.median(ms["bf16", what])
                          / statistics.median(ms["f32", what]))
    timed = "; ".join(
        f"ms/{what} (quartiles of {n}) bf16 {quart(ms['bf16', what])}, f32 "
        f"{quart(ms['f32', what])}, medians' ratio {ratio(what):.3f}"
        for what, n in (("request", BF16_NET_TIMED_REQUESTS),
                        ("step", BF16_NET_TIMED_STEPS)))
    ref_graphs = request[:n_ref]
    one = collate_graphs(ref_graphs, **collate)
    with torch.inference_mode():
        ref = first_output(copy.deepcopy(cpu_model).to(torch.float64)(
            as_float64(one))).numpy()
        with compute_dtype_env("bfloat16"):
            cpu_bf16 = first_output(cpu_model(one)).numpy()
    pick = lambda a, i, g: a[i, :g.num_nodes] if node_level else a[i]
    gap = lambda got: max(float(np.abs(pick(got, i, g) - pick(ref, i, g))
                                .max()) for i, g in enumerate(ref_graphs))
    served = outs["bf16"]
    err = max(float(np.abs(np.asarray(served[i]) - pick(ref, i, g)).max())
              for i, g in enumerate(ref_graphs))
    err_cpu = gap(cpu_bf16)
    finite = all(np.isfinite(np.asarray(o, np.float64)).all()
                 for out in outs.values() for o in out)
    print(f"{label}: {BF16_NET_ROUNDS} rounds of a request of {per} graphs "
          f"and a step on them under each policy in turns, then warm, in "
          f"turns, {timed}; step losses "
          f"{[round(x, 6) for x in losses]}; launches a request "
          f"{serve_want}, a step {step_want}, by entry point {dict(tally)};"
          f" {len(ref_graphs)} graphs' bf16 logits off the float64 CPU "
          f"forward {err:.3e} (at most {BF16_MODEL_FACTOR}x the CPU bf16 "
          f"route's {err_cpu:.3e}); max |logit| "
          f"{float(np.abs(ref).max()):.3f}; on {card}", flush=True)
    if not finite or not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite logits or losses")
    if err > BF16_MODEL_FACTOR * err_cpu:
        raise AssertionError(f"{label}: bf16 logits off float64 by {err}, "
                             f"the CPU bf16 route's {err_cpu}")
    bf16_step_parity(initial, ref_graphs, device, f"{label} step",
                     collate, step_cfg, params)
    return runs


def bf16_zinc_fused(graphs, device, card):
    """The ZINC regressor (DiffGraphTransformerGenGCN at ZINC_CFG) on the
    "fused" route under the bf16 policy and with it unset
    (`bf16_policy_net`): 9 fused_attn_fwd and 1 modulation_fwd a request,
    the fused pair through `_bf16` under the policy; then the route check
    at BF16_ROUTE_LAYERS layers (`bf16_route_check`: the fused pair takes
    pe and deg float32, so one bf16 route). Returns the launches."""
    build = lambda seed: DiffGraphTransformerGenGCN(
        **ZINC_CFG, attention_impl="fused", seed=seed, device=device)
    collate = {"max_nodes": ZINC_NODES}
    runs = bf16_policy_net(
        "bf16 zinc [fused]", build, graphs, ZINC_GRAPHS, collate, device,
        card, "graph_reg", ZINC_REQUEST_LAUNCHES["fused"],
        ZINC_STEP_LAUNCHES["fused"],
        TrainConfig(task="graph_reg", regularization=0.1, sign_flip=False),
        STEP_PARAMS,
        TrainConfig(task="graph_reg", lr=1e-3, weight_decay=1e-5,
                    sign_flip=True, seed=0), BF16_REF_GRAPHS["zinc"])
    model = DiffGraphTransformerGenGCN(
        **dict(ZINC_CFG, nb_layers=BF16_ROUTE_LAYERS),
        attention_impl="fused", seed=1, device=device)
    calibrate_batch_norm(model, collate_graphs(graphs[:16], **collate),
                         device)
    bf16_route_check(model, graphs[:16], device, "bf16 route zinc [fused]",
                     collate, routes={"bf16": ("bfloat16", "1"),
                                      "f32": (None, None)},
                     suffix={"bf16": "_bf16"})
    return runs


def bf16_lpe(device, card):
    """The bf16 phase on the fused MLP pair: SANNodeSpectra at SAN_CFG
    (the san phase's widths and batch) and the lpe phase's four nets
    (LPE_NETS: SAN_NodeLPE, the PATTERN SAN_NodeLPE, SAN_EdgeLPE, GATFeTA)
    built by their config trainers, each through `bf16_policy_net` (a
    request launches the eigen-PE head's fused_mlp_fwd, a step its
    fused_mlp_fwd and _bwd, once per encoder layer of the head; GATFeTA
    none); then SANNodeSpectra's route check at BF16_ROUTE_LAYERS layers.
    Returns the launches."""
    graphs = zinc_categorical_dataset(seed=3, n_graphs=SAN_GRAPHS)
    apply_laplace_decomp(graphs, SAN_FREQS)
    heads = SAN_CFG["lpe_layers"]
    collate = {"max_nodes": SAN_NODES}
    mlp = lambda n: ({"fused_mlp_fwd": n}, {"fused_mlp_fwd": n,
                                              "fused_mlp_bwd": n})
    runs = bf16_policy_net(
        "bf16 san", lambda seed: SANNodeSpectra(**SAN_CFG, seed=seed,
                                                device=device),
        graphs, SAN_GRAPHS, collate, device, card, "graph_reg", *mlp(heads),
        TrainConfig(task="graph_reg", sign_flip=False), SAN_STEP_PARAMS,
        TrainConfig(task="graph_reg", lr=1e-3, weight_decay=1e-5,
                    sign_flip=True, seed=0), BF16_REF_GRAPHS["san"])
    for label, config, overrides, trainer, per, nodes, n_heads, params \
            in LPE_NETS:
        _, transform, task, extra, make, cfg = lpe_build(
            config, overrides, trainer, "cpu", seed=0)
        net_graphs = make(per)
        transform(net_graphs)
        p = cfg["params"]
        runs += bf16_policy_net(
            f"bf16 lpe {label}",
            lambda seed, c=config, o=overrides, t=trainer: lpe_build(
                c, o, t, device, seed=seed)[0],
            net_graphs, per, dict(max_nodes=nodes, **extra), device, card,
            task, *mlp(n_heads), TrainConfig(task=task, sign_flip=False),
            params, TrainConfig(task=task, lr=p["init_lr"],
                                weight_decay=p["weight_decay"],
                                sign_flip=n_heads > 0, seed=0),
            BF16_REF_GRAPHS["lpe"])
    model = SANNodeSpectra(**dict(SAN_CFG, n_layers=BF16_ROUTE_LAYERS),
                           seed=1, device=device)
    calibrate_batch_norm(model, collate_graphs(graphs[:16], **collate),
                         device)
    bf16_route_check(model, graphs[:16], device, "bf16 route san", collate,
                     params=BF16_SAN_ROUTE_PARAMS,
                     routes={"bf16": ("bfloat16", "1"), "f32": (None, None)},
                     suffix={"bf16": "_bf16"})
    return runs


def bf16_zinc(device, card, graphs):
    """The bf16 phase on the ZINC regressor (DiffGraphTransformerGenGCN at
    ZINC_CFG) on "flash" and "modulation", on `make_zinc_graphs()`:
    `zinc_serve` and `zinc_train`
    under the policy and with it unset, their launches exact (on "flash"
    by entry point too; "modulation" launches its float32 kernels on
    float32 scores, as the JAX layer does), then each combination's
    request and epoch in interleaved rounds (`compare_routes`), and one
    step on 16 graphs under the policy (`bf16_step_parity`), and the
    route check at 2 layers (`bf16_route_check`). Returns the
    launches."""
    runs, request_fns, step_fns = [], {}, {}
    for impl in ("flash", "modulation"):
        for p, value, suffix in (("bf16", "bfloat16", "_bf16"),
                                 ("f32", None, "")):
            tag = f" {p}"
            with entry_point_tally() as tally:
                with compute_dtype_env(value):
                    launches, _, req = zinc_serve(graphs, device, card, impl,
                                                  tag=tag)
                    runs.append(launches)
                    launches2, _, step = zinc_train(graphs, device, card,
                                                    impl, tag=tag)
                    runs.append(launches2)
            # the counters leave out the batch-norm calibration's forward
            # (zinc_serve) and `step_syncs`'s step (zinc_train); the tally
            # sees them
            total = {k: launches[k] + launches2[k]
                     + ZINC_REQUEST_LAUNCHES[impl][k]
                     + ZINC_STEP_LAUNCHES[impl][k] for k in FLASH_ROUTE}
            check_tally(f"bf16 zinc [{impl}{tag}]", tally,
                        policy_launches(total, suffix))
            request_fns[f"{impl}{tag}"] = _with_env(req, value)
            step_fns[f"{impl}{tag}"] = _with_env(step, value)
    compare_routes(request_fns, step_fns, card,
                   f"bf16 zinc at B={ZINC_GRAPHS}, N={ZINC_NODES}",
                   BF16_ZINC_ROUNDS)
    model = DiffGraphTransformerGenGCN(**ZINC_CFG, attention_impl="flash",
                                       seed=1, device=device)
    bf16_step_parity(model, graphs[:16], device, "bf16 zinc train [flash]",
                     dict(max_nodes=ZINC_NODES),
                     TrainConfig(task="graph_reg", regularization=0.1,
                                 sign_flip=False), STEP_PARAMS)
    bf16_route_zinc(graphs, device)
    return runs


def _with_env(fn, value):
    """`fn` run with FETA_COMPUTE_DTYPE set to `value` (None: unset)."""
    def run():
        with compute_dtype_env(value):
            return fn()
    return run


def bf16_products(device, card, b=N_GRAPHS // 2, n=N_NODES, f=64):
    """The policy's plain product with the longest sum, the Chebyshev
    step Lhat Tx at the SBM batch ([B, N, N] by [B, N, H·dh], K = N), three
    ways on bf16 operands: the port's (`ops/cheb.py`: the float32 product
    of their values in blocks of 64 nodes, rounded once to bf16) and
    cuBLAS's bf16 product with the reduced-precision reduction allowed
    (torch's default) and not. Prints each one's ms (CUDA events, median
    of 25), max abs error from float64 and share of entries off the
    float64 product rounded to bf16; the port sets no cuBLAS flag, as it
    sends no bf16 product to cuBLAS."""
    gen = torch.Generator(device).manual_seed(n)
    a = torch.rand((b, n, n), device=device, generator=gen).to(torch.bfloat16)
    x = torch.randn((b, n, f), device=device, generator=gen).to(torch.bfloat16)
    want = a.double() @ x.double()
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    text = []
    try:
        for label, fn, reduced in (
                ("port (float32 blocks, one rounding)",
                 lambda: node_matmul(a, x), flag),
                ("cuBLAS bf16, reduced-precision reduction allowed",
                 lambda: a @ x, True),
                ("cuBLAS bf16, not allowed", lambda: a @ x, False)):
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
                = reduced
            with torch.inference_mode():
                got = fn()
                ms = time_ms(fn)
            err = float((got.double() - want).abs().max())
            off = float((got != want.to(torch.bfloat16)).double().mean())
            text.append(f"{label} {ms:.4f} ms, err {err:.3e}, "
                        f"{100 * off:.2f} % off the rounded float64")
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    print(f"bf16 products: Lhat Tx [{b}, {n}, {n}] x [{b}, {n}, {f}]: "
          + "; ".join(text) + f" (max |y| "
          f"{float(want.abs().max()):.3f}); on {card}", flush=True)


def bf16_slice(graphs, device, card, cli_device="cuda"):
    """The bf16 phase (the bf16 compute policy, FETA_COMPUTE_DTYPE=
    bfloat16): kernels #1-#4 in bf16 (`check_bf16_kernels`), then #10-#13
    (`check_bf16_fused`, `check_bf16_mlp`), the SBM model at N=1024
    (`bf16_sbm`), the ZINC regressor on "flash" and "modulation"
    (`bf16_zinc`) and on "fused" (`bf16_zinc_fused`), SANNodeSpectra and
    the lpe phase's nets (`bf16_lpe`), feta-torch-zinc under the policy,
    2 + 2 epochs bit for bit against 4, every flash launch through a bf16
    entry point, and the LPE config trainer (SAN_NodeLPE) so, every MLP
    launch through a `_bf16` entry point; between the kernels and the
    models, the policy's longest plain product three ways
    (`bf16_products`) and the SBM model's route check at 2 layers
    (`bf16_route_check`; the ZINC, fused and SAN ones are in their
    functions). Returns the kernels' JSON fields and the launches."""
    rows = check_bf16_kernels(device)
    for name, fields in {**check_bf16_fused(device),
                         **check_bf16_mlp(device)}.items():
        rows[name] = fields
    bf16_products(device, card)
    bf16_route_sbm(graphs, device)
    runs, med = bf16_sbm(graphs, device, card)
    zinc_graphs = make_zinc_graphs()
    runs += bf16_zinc(device, card, zinc_graphs)
    runs += bf16_zinc_fused(zinc_graphs, device, card)
    runs += bf16_lpe(device, card)
    with tempfile.TemporaryDirectory() as workdir, \
            compute_dtype_env("bfloat16"), entry_point_tally() as tally:
        launches = cli_exact_resume("zinc_bf16", cli_zinc.main,
                                    CLI_ZINC_ARGV, workdir, card,
                                    cli_device)
        check_tally("cli zinc_bf16", tally,
                    policy_launches(launches, "_bf16"))
        runs.append(launches)
        tally.clear()
        name, main_fn, argv = CLI_LPE_RUNS[0]
        launches = cli_exact_resume(f"{name}_bf16", main_fn, argv, workdir,
                                    card, cli_device)
        check_tally(f"cli {name}_bf16", tally,
                    policy_launches(launches, "_bf16", MLP_ROUTE))
    runs.append(launches)
    print(f"bf16 against float32, SBM N={N_NODES} (medians, in turns): ms a "
          f"request of {N_GRAPHS} graphs {med['bf16'][0]:.2f} / "
          f"{med['f32'][0]:.2f} ({med['bf16'][0] / med['f32'][0]:.3f}x), ms "
          f"a step of {N_GRAPHS // 2} {med['bf16'][1]:.2f} / "
          f"{med['f32'][1]:.2f} ({med['bf16'][1] / med['f32'][1]:.3f}x); "
          f"kernels bf16 / float32 ms on the same values " + ", ".join(
              f"{k} {v['ms_bf16']:.4f} / {v['ms_f32_twin']:.4f}"
              for k, v in rows.items()) + f"; on {card}", flush=True)
    return rows, runs


def logs_columns(out):
    """The header of the logs.csv a CLI wrote under `out` (the GraphiT
    CLIs nest it in directories named after their flags)."""
    (path,) = [os.path.join(root, "logs.csv")
               for root, _, files in os.walk(out) if "logs.csv" in files]
    with open(path) as f:
        return f.readline().strip().split(",")


def cli_train(name, main, argv, workdir, card, device="cuda"):
    """One CLI trainer for CLI_EPOCHS epochs into a checkpoint directory,
    then one more epoch resumed from it; returns the launches of both runs
    and the checkpoint directory. Holds logs.csv's columns, finite losses,
    the checkpoints written and the resumed epoch."""
    ckpt = os.path.join(workdir, f"{name}_ckpt")
    out = os.path.join(workdir, f"{name}_out")
    common = argv + ["--ckpt-dir", ckpt, "--device", device]
    reset_launches()
    t0 = time.perf_counter()
    result = main(common + ["--epochs", str(CLI_EPOCHS), "--outdir", out])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resumed = main(common + ["--epochs", str(CLI_EPOCHS + 1), "--resume"])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches = read_launches()
    columns = logs_columns(out)
    losses = [r["loss"] for r in result["history"] + resumed["history"]]
    print(f"cli {name}: {CLI_EPOCHS} epochs in {train_s:.2f} s and one "
          f"resumed epoch in {resume_s:.2f} s on {card}; epoch losses "
          f"{[round(x, 6) for x in losses]}; best_val {result['best_val']}, "
          f"test {result.get('test')}; logs.csv columns {columns}; "
          f"checkpoints {sorted(os.listdir(ckpt))}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if columns != CLI_LOG_COLUMNS[name]:
        raise AssertionError(f"cli {name}: logs.csv columns {columns}")
    if [r["epoch"] for r in resumed["history"]] != [CLI_EPOCHS]:
        raise AssertionError(f"cli {name}: --resume ran epochs "
                             f"{[r['epoch'] for r in resumed['history']]}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"cli {name}: losses {losses}")
    if "fit_meta.json" not in os.listdir(ckpt):
        raise AssertionError(f"cli {name}: no checkpoint sidecar in {ckpt}")
    check_cli_launches(name, launches, CLI_KERNELS[name])
    return launches, ckpt


def cli_exact_resume(name, main, argv, workdir, card, device="cuda",
                     exact=None):
    """A CLI trainer for CLI_EPOCHS epochs into a checkpoint directory,
    resumed to 2 * CLI_EPOCHS, against 2 * CLI_EPOCHS epochs in one run:
    every logged number but the times, best_val and every weight bit for
    bit. Holds logs.csv's columns and the kernels launched (none, for the
    LSPE nets; `exact` times each, if given); returns the launches."""
    ckpt = os.path.join(workdir, f"{name}_ckpt")
    out = os.path.join(workdir, f"{name}_out")
    common = argv + ["--device", device]
    reset_launches()
    t0 = time.perf_counter()
    first = main(common + ["--epochs", str(CLI_EPOCHS), "--ckpt-dir", ckpt,
                           "--outdir", out])
    resumed = main(common + ["--epochs", str(2 * CLI_EPOCHS), "--ckpt-dir",
                             ckpt, "--resume"])
    torch.cuda.synchronize()
    split_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    full = main(common + ["--epochs", str(2 * CLI_EPOCHS)])
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    launches = read_launches()
    rows = lambda r: [{k: v for k, v in row.items() if k != "time"}
                      for row in r["history"]]
    columns = logs_columns(out)
    differ = sorted(k for k, v in full["state"].items()
                    if not torch.equal(resumed["state"][k], v))
    losses = [r["loss"] for r in full["history"]]
    print(f"cli {name}: {CLI_EPOCHS} epochs and a resume to "
          f"{2 * CLI_EPOCHS} in {split_s:.2f} s, {2 * CLI_EPOCHS} epochs in "
          f"one run in {full_s:.2f} s on {card}; epoch losses "
          f"{[round(x, 6) for x in losses]}; best_val {full['best_val']}, "
          f"test {full.get('test')}; resumed run bit-equal: logged rows "
          f"{rows(first) + rows(resumed) == rows(full)}, best_val "
          f"{resumed['best_val'] == full['best_val']}, weights differing "
          f"{len(differ)} of {len(full['state'])}; logs.csv columns "
          f"{columns}; launches {launches}", flush=True)
    if columns != CLI_LOG_COLUMNS[name]:
        raise AssertionError(f"cli {name}: logs.csv columns {columns}")
    if rows(first) + rows(resumed) != rows(full) or differ \
            or resumed["best_val"] != full["best_val"]:
        raise AssertionError(f"cli {name}: the resumed run is not the "
                             f"uninterrupted one (weights {differ[:5]})")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"cli {name}: losses {losses}")
    check_cli_launches(name, launches, CLI_KERNELS[name], exact)
    return launches


def cli_once(name, main, argv, workdir, card, device="cuda"):
    """One run of a CLI for CLI_EPOCHS epochs: logs.csv's columns (the
    supervised GCKN CLIs write none: their result), finite losses, the
    kernels of its path and no other; returns the launches."""
    out = os.path.join(workdir, f"{name}_out")
    sup = name.startswith("gckn_sup")
    reset_launches()
    t0 = time.perf_counter()
    result = main(argv + ["--epochs", str(CLI_EPOCHS), "--device", device]
                  + ([] if sup else ["--outdir", out]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    values = ([result] if sup else
              [r["loss"] for r in result["history"]])
    print(f"cli {name}: {CLI_EPOCHS} epochs in {secs:.2f} s on {card}; "
          + (f"test metric {result}" if sup else
             f"epoch losses {[round(x, 6) for x in values]}, test "
             f"{result.get('test')}, logs.csv columns {logs_columns(out)}")
          + f"; launches { {k: v for k, v in launches.items() if v} }",
          flush=True)
    if not sup and logs_columns(out) != CLI_LOG_COLUMNS[name]:
        raise AssertionError(f"cli {name}: logs.csv columns "
                             f"{logs_columns(out)}")
    if not all(np.isfinite(values)):
        raise AssertionError(f"cli {name}: {values}")
    check_cli_launches(name, launches, CLI_KERNELS[name])
    return launches


def cli_flash_launches(batches, layers=MOLHIV_CFG["nb_layers"]):
    """The exact #1-#4 launches of `cli_exact_resume`'s three fits (4 *
    CLI_EPOCHS epochs in all) of a FeTA CLI with `layers` layers, its last
    one filtered, on (training, validation, test) batches a fit: a forward
    launches flash_fwd a layer and colstat twice, a step one forward and
    both backward passes a layer; each epoch evaluates the validation
    batches, each fit ends on the test batches."""
    train, val, test = batches
    epochs = 4 * CLI_EPOCHS
    steps = epochs * train
    forwards = steps + epochs * val + 3 * test
    return {"flash_fwd": layers * forwards, "colstat": 2 * forwards,
            "flash_bwd_q": layers * steps, "flash_bwd_k": layers * steps}


def check_cli_launches(label, launches, kernels, exact=None):
    """Every kernel of the path launched (`exact` times, if given), no
    other."""
    missing = sorted(k for k in kernels if not launches[k])
    stray = sorted(k for k, v in launches.items() if v and k not in kernels)
    if missing or stray or (exact and launches != {**NONE, **exact}):
        raise AssertionError(f"cli {label}: launches {launches}; kernels "
                             f"not launched {missing}, off the path {stray}"
                             f"; expected {exact or sorted(kernels)}")


def request_body(graphs) -> bytes:
    """The JSON body of a POST /predict of raw ZINC graphs (ids, edges,
    bond types)."""
    return json.dumps({"graphs": [{"x_int": g.x.reshape(-1).tolist(),
                                   "edge_index": g.edge_index.tolist(),
                                   "edge_type": g.edge_type.tolist()}
                                  for g in graphs]}).encode()


def post_body(port, body: bytes):
    """POST /predict of a request body; the logits as float32."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return np.asarray(json.loads(r.read())["logits"], np.float32)


def spread(ms) -> str:
    """Median, 10th and 90th percentiles, least and most of times in ms."""
    q = np.percentile(ms, [50, 10, 90])
    return (f"median {q[0]:.2f} ms (p10 {q[1]:.2f}, p90 {q[2]:.2f}, min "
            f"{min(ms):.2f}, max {max(ms):.2f})")


def request_stages(body: bytes, preprocess, pred, reps: int) -> dict:
    """One request's server-side work split into its stages, in this
    process, `reps` times: ms per stage (JSON decode into graphs, the
    host eigen-PE, the padded collation alone, `Predictor.predict` with
    its own collation, forward and copy back, the JSON encode)."""
    stages = {k: [] for k in ("decode", "eigen_pe", "collate", "predict",
                              "encode")}
    for _ in range(reps):
        t0 = time.perf_counter()
        graphs = [_graph_from_json(g) for g in json.loads(body)["graphs"]]
        t1 = time.perf_counter()
        preprocess(graphs)
        t2 = time.perf_counter()
        collate_graphs(graphs + [graphs[0]] * (pred.max_batch - len(graphs)),
                       **pred.collate_kwargs)
        t3 = time.perf_counter()
        logits = pred.predict(graphs)
        t4 = time.perf_counter()
        json.dumps({"logits": logits.tolist()})
        t5 = time.perf_counter()
        for k, a, b in (("decode", t0, t1), ("eigen_pe", t1, t2),
                        ("collate", t2, t3), ("predict", t3, t4),
                        ("encode", t4, t5)):
            stages[k].append((b - a) * 1e3)
    return {k: statistics.median(v) for k, v in stages.items()}


def cli_serve(ckpt, card, device="cuda", model_name="SAN_NodeSpectra",
              timed=CLI_TIMED_REQUESTS, label="serve", config=CLI_CONFIG,
              mlp_launches=2, stage_reps=CLI_STAGE_REPS):
    """serve_main from the config trainer's checkpoint (`config`, with
    --model `model_name` unless None), in the background with --warmup:
    CLI_REQUESTS POST /predict requests of CLI_REQUEST_GRAPHS raw
    ZINC-shaped graphs one after another, then the same requests all at
    once from CLI_REQUESTS threads (handler threads that share one
    Predictor), each answer held to an in-process Predictor restored from
    the same checkpoint; then `timed` more one after another, timed, and
    one request's server-side stages timed in this process."""
    model_args = ["--model", model_name] if model_name else []
    t0 = time.perf_counter()
    srv, port, _ = cli_serve_main.main(
        ["--config", config, *model_args, "--ckpt-dir", ckpt, "--warmup",
         "--port", "0", "--device", device], background=True)
    start_s = time.perf_counter() - t0
    graphs = zinc_categorical_dataset(seed=11, n_graphs=CLI_REQUESTS
                                      * CLI_REQUEST_GRAPHS)
    requests = [graphs[i:i + CLI_REQUEST_GRAPHS]
                for i in range(0, len(graphs), CLI_REQUEST_GRAPHS)]
    bodies = [request_body(req) for req in requests]
    concurrent = [None] * len(bodies)

    def post_at_once(i, barrier):
        barrier.wait()
        concurrent[i] = post_body(port, bodies[i])

    try:
        reset_launches()
        served, call_ms = [], []
        for body in bodies:
            t0 = time.perf_counter()
            served.append(post_body(port, body))
            call_ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_launches()
        barrier = threading.Barrier(len(bodies))
        threads = [threading.Thread(target=post_at_once, args=(i, barrier))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        timed_ms = []
        for k in range(timed):
            t0 = time.perf_counter()
            post_body(port, bodies[k % len(bodies)])
            timed_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        srv.shutdown()
        srv.server_close()
    model, preprocess, _ = cli_serve_main.build_from_config(
        config, model_name, device=device)
    ref = Predictor(model, device=device, ckpt_dir=ckpt, max_batch=64,
                    collate_kwargs={"max_nodes": CLI_MAX_NODES})
    errs, errs_at_once = [], []
    for req, got, at_once in zip(requests, served, concurrent):
        preprocess(req)
        want = ref.predict(req)
        for answer, into in ((got, errs), (at_once, errs_at_once)):
            if answer is None or answer.shape != want.shape \
                    or not np.isfinite(answer).all():
                raise AssertionError(
                    f"cli serve: logits {getattr(answer, 'shape', None)} "
                    f"vs {want.shape}")
            into.append(float(np.abs(answer - want).max()))
    # the window on the card: all the requests' graphs as one request of
    # many chunks (each chunk's logits copied back into a page-locked
    # buffer of its own, drained on its event) against one chunk a call
    window = Predictor(model, device=device, ckpt_dir=ckpt,
                       max_batch=CLI_WINDOW_CHUNK,
                       collate_kwargs={"max_nodes": CLI_MAX_NODES})
    whole = window.predict(graphs)
    one = np.concatenate([window.predict(graphs[i:i + CLI_WINDOW_CHUNK])
                          for i in range(0, len(graphs), CLI_WINDOW_CHUNK)])
    if not np.array_equal(whole, one):
        raise AssertionError("cli serve: a request of "
                             f"{len(graphs) // CLI_WINDOW_CHUNK} chunks "
                             "through the window differs from one chunk a "
                             f"call by {float(np.abs(whole - one).max())}")
    stages = request_stages(bodies[0], preprocess, ref, stage_reps)
    print(f"cli {label}: {type(model).__name__}; "
          f"{len(graphs) // CLI_WINDOW_CHUNK} chunks of "
          f"{CLI_WINDOW_CHUNK} through the Predictor's window of "
          f"{serve_mod.WINDOW} bit-equal to one chunk a call", flush=True)
    print(f"cli {label}: serve_main --warmup from the checkpoint ready in "
          f"{start_s:.2f} s; {len(requests)} POST /predict of "
          f"{CLI_REQUEST_GRAPHS} raw graphs (server-side PEs, padded "
          f"to N={CLI_MAX_NODES}) one after another: ms/request "
          f"{[round(t, 2) for t in call_ms]}; max abs err against the "
          f"in-process Predictor per request {[f'{e:.1e}' for e in errs]}, "
          f"and with all {len(requests)} sent at once "
          f"{[f'{e:.1e}' for e in errs_at_once]}; launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print(f"cli {label}: {timed} more requests one after "
          f"another on {card}: {spread(timed_ms)} a request = "
          f"{CLI_REQUEST_GRAPHS / statistics.median(timed_ms) * 1e3:.1f} "
          f"graphs/s; one request's server-side stages in this process, "
          f"median of {stage_reps} (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()), flush=True)
    if max(errs + errs_at_once) > CLI_SERVE_TOL:
        raise AssertionError(f"cli {label}: served logits off the "
                             f"Predictor's by {max(errs + errs_at_once)}")
    if mlp_launches:
        check_cli_launches(label, launches, {"fused_mlp_fwd"}, exact={
            "fused_mlp_fwd": mlp_launches * len(requests)})
    else:
        check_cli_launches(label, launches, set())
    return launches


def cli_slice(card, device="cuda"):
    """The cli phase: the port's entry points, run as a user runs them;
    returns the launches of each run."""
    with tempfile.TemporaryDirectory() as workdir:
        config, ckpt = cli_train(
            "config", cli_zinc_config.main,
            ["--config", CLI_CONFIG, "--model", "SAN_NodeSpectra",
             "--data-dir", CLI_FIXTURES], workdir, card, device)
        serve = cli_serve(ckpt, card, device)
        zinc, _ = cli_train("zinc", cli_zinc.main, CLI_ZINC_ARGV, workdir,
                            card, device)
        molhiv, _ = cli_train(
            "molhiv", cli_molhiv.main,
            ["--datadir", os.path.join(workdir, "no-dataset")], workdir,
            card, device)
        sbm, _ = cli_train(
            "sbm", cli_sbm.main,
            ["--datadir", CLI_FIXTURES, "--dataset", "FIXTURE", "--lappe"],
            workdir, card, device)
        tu, _ = cli_train(
            "tu", cli_tu.main,
            ["--datadir", CLI_FIXTURES, "--dataset", "TUFIX", "--lappe"],
            workdir, card, device)
        runs = [config, serve, zinc, molhiv, sbm, tu]
        for name, main, argv in CLI_LPE_RUNS:
            launches, ckpt = cli_train(name, main, argv, workdir, card,
                                       device)
            runs.append(launches)
            if name == "config_lpe":
                runs.append(cli_serve(ckpt, card, device, model_name=None,
                                      timed=CLI_TIMED_REQUESTS // 4,
                                      label="serve_lpe"))
        runs += cli_lspe(workdir, card, device)
        for name, main, argv in CLI_GRAPHIT_RUNS:
            runs.append(cli_train(name, main, argv, workdir, card,
                                  device)[0])
        for name, main, argv, batches in CLI_OGB_RUNS:
            runs.append(cli_exact_resume(
                name, main, argv, workdir, card, device,
                exact=batches and {**NONE, **cli_flash_launches(batches)}))
        runs.append(cli_exact_resume(
            "zinc_gckn", cli_zinc_gckn.main, ["--datadir", CLI_FIXTURES],
            workdir, card, device, exact={**NONE, **cli_flash_launches(
                (1, 1, 1), layers=ZINC_CFG["nb_layers"])}))
        for name, main, argv in CLI_GCKN_RUNS:
            runs.append(cli_once(name, main, argv + CLI_GCKN_SAMPLES,
                                 workdir, card, device))
        runs.append(cli_exact_resume(*CLI_GAT_B128, workdir, card, device,
                                     exact=NONE))
    return runs


def cli_lspe(workdir, card, device="cuda"):
    """The cli phase's LSPE runs: CLI_LSPE_RUNS with their exact resume,
    then the ZINC trainer's GraphiT-Spectra-LSPE (CLI_LSPE_SERVE, --model
    GraphiTSpectra) served by serve_main from its checkpoint; returns the
    launches of each run."""
    runs = [cli_exact_resume(name, main, argv, workdir, card, device)
            for name, main, argv in CLI_LSPE_RUNS]
    launches, ckpt = cli_train(
        "config_lspe", cli_zinc_config.main,
        ["--config", CLI_LSPE_SERVE, "--model", "GraphiTSpectra",
         "--data-dir", CLI_FIXTURES], workdir, card, device)
    runs.append(launches)
    runs.append(cli_serve(ckpt, card, device, model_name="GraphiTSpectra",
                          timed=CLI_TIMED_REQUESTS // 10,
                          label="serve_lspe", config=CLI_LSPE_SERVE,
                          mlp_launches=0, stage_reps=CLI_STAGE_REPS // 5))
    return runs


@contextlib.contextmanager
def compute_dtype_env(value, apply=True):
    """FETA_COMPUTE_DTYPE set to `value` (None: unset) inside, as it was
    after; nothing where `apply` is false."""
    old = os.environ.get("FETA_COMPUTE_DTYPE")
    if apply:
        if value is None:
            os.environ.pop("FETA_COMPUTE_DTYPE", None)
        else:
            os.environ["FETA_COMPUTE_DTYPE"] = value
    try:
        yield
    finally:
        if apply:
            if old is None:
                os.environ.pop("FETA_COMPUTE_DTYPE", None)
            else:
                os.environ["FETA_COMPUTE_DTYPE"] = old


def as_float64(batch):
    return dataclasses.replace(batch, **{
        f.name: getattr(batch, f.name).double()
        for f in dataclasses.fields(batch)
        if torch.is_tensor(getattr(batch, f.name))
        and getattr(batch, f.name).is_floating_point()})


@contextlib.contextmanager
def plain_kernels():
    """The N=2048 path's kernel wrappers swapped for their plain PyTorch
    versions, which run on CUDA tensors too: the same model on the same
    card without the hand-written kernels (`--precision`). Nothing
    launches or counts inside."""
    swaps = [(fl_mod, "flash_fwd_hf", fl_mod.flash_fwd_plain),
             (fl_mod, "flash_bwd_q_hf", fl_mod.flash_bwd_q_plain),
             (fl_mod, "flash_bwd_k_hf", fl_mod.flash_bwd_k_plain),
             (cs_mod, "colstat", cs_mod.colstat_plain)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def plain_mlp():
    """The fused-MLP wrappers swapped for their plain PyTorch versions,
    which run on CUDA tensors too (nothing launches or counts inside)."""
    saved = fm_mod.fused_mlp_fwd, fm_mod.fused_mlp_bwd
    fm_mod.fused_mlp_fwd = fm_mod.fused_mlp_plain
    fm_mod.fused_mlp_bwd = fm_mod.fused_mlp_bwd_plain
    try:
        yield
    finally:
        fm_mod.fused_mlp_fwd, fm_mod.fused_mlp_bwd = saved


def logits_errors(model, graphs, collate, serve, plain=False):
    """Max abs errors against a float64 CPU forward of graphs[0] of its
    logits as `serve()` returns them on CUDA (with `plain`, also with the
    plain versions on the card) and on the CPU in float32; whether the
    CUDA ones lie within SLICE_TOL, and the float64 max |logit|."""
    rows = slice(0, graphs[0].num_nodes)
    one = collate_graphs(graphs[:1], **collate)
    with torch.inference_mode():
        ref = copy.deepcopy(model).to("cpu", torch.float64)(
            as_float64(one))[0][0, rows].numpy()
        ref32 = copy.deepcopy(model).to("cpu")(one)[0][0, rows].numpy()
    got = serve()
    gap = lambda a: float(np.abs(a - ref).max())
    errs = dict(cuda=gap(got), cpu32=gap(ref32),
                scale=float(np.abs(ref).max()),
                within=bool(np.allclose(got, ref, **SLICE_TOL)))
    if plain:
        with plain_kernels():
            errs["cuda_plain"] = gap(serve())
    return errs


def step_errors(initial, graphs, device, collate, cfg, params, optional=(),
                policy=None):
    """One step from the same weights (sign flip off, so no random numbers
    enter) on CUDA in float32, on the CPU in float32 and on the CPU in
    float64. Returns the losses, each float32 route's gradient error per
    named parameter (max abs err / max |g| of the float64 step), the
    float64 step's max |g| and the CPU steps' seconds. The float64 step is
    the reference: from random weights the 10-layer network's gradients
    reach |g| ~ 40 and amplify f32 rounding, so each float32 route is held
    to it, not to the other. A name in `optional` whose parameter gets no
    gradient is left out; any other name must get one. `collate` is
    collate_graphs' keyword arguments, or a function of the graphs that
    builds the batch (`pack_graphs`). `policy`: the FETA_COMPUTE_DTYPE of
    the CUDA and "cpu32" routes (then the CPU's route under that policy),
    the float64 step running with it unset."""
    batch = (collate(graphs) if callable(collate)
             else collate_graphs(graphs, **collate))
    runs = {"cuda": (copy.deepcopy(initial), batch.to(device)),
            "cpu32": (copy.deepcopy(initial).to("cpu"), batch),
            "cpu64": (copy.deepcopy(initial).to("cpu", torch.float64),
                      as_float64(batch))}
    loss, grads, secs = {}, {}, {}
    for route, (model, b) in runs.items():
        t0 = time.perf_counter()
        with compute_dtype_env(policy if route != "cpu64" else None,
                               policy is not None):
            loss[route] = float(Trainer(model, cfg).step(b))
        secs[route] = time.perf_counter() - t0
        grads[route] = {name: model.get_parameter(name).grad.double().cpu()
                        for name in params
                        if model.get_parameter(name).grad is not None
                        or name not in optional}
    params = [name for name in params if name in grads["cpu64"]]
    scale = {name: float(grads["cpu64"][name].abs().max()) for name in params}
    rel = {r: {name: float((grads[r][name] - grads["cpu64"][name]).abs()
                           .max()) / max(scale[name], 1e-300)
               for name in params}
           for r in ("cuda", "cpu32")}
    if not all(torch.isfinite(g).all() for g in grads["cuda"].values()):
        rel["cuda"] = dict.fromkeys(params, float("inf"))
    return loss, rel, scale, secs


def step_parity(initial, graphs, device, label, collate, cfg, params,
                loss_rtol=STEP_LOSS_RTOL, cpu_factor=None, rank=False):
    """The CUDA step's loss within `loss_rtol` of the float64 step's and
    each named gradient within STEP_GRAD_REL of its largest entry; with
    `cpu_factor`, a loss or gradient beyond that may instead lie within
    `cpu_factor` times the error of the CPU's float32 step. With `rank`,
    also every parameter's error ranked (`rank_step_errors`)."""
    rest = ([n for n, _ in initial.named_parameters() if n not in params]
            if rank else [])
    loss, rel, scale, secs = step_errors(initial, graphs, device, collate,
                                         cfg, list(params) + rest, rest)
    if rank:
        rank_step_errors(label, rel, scale)
    routes = ("cuda", "cpu32")
    report = [f"{name} (max |g| {scale[name]:.3e}): " + ", ".join(
        f"{r} {rel[r][name]:.2e}" for r in routes) for name in params]
    loss_err = {r: abs(loss[r] - loss["cpu64"]) / abs(loss["cpu64"])
                for r in routes}
    factor = cpu_factor or 0.0
    bad = [name for name in params if not (
        rel["cuda"][name] <= STEP_GRAD_REL
        or rel["cuda"][name] <= factor * rel["cpu32"][name])]
    print(f"{label}: one step on {len(graphs)} graphs from the initial weights;"
          f" loss " + ", ".join(f"{r} {loss[r]:.8f}" for r in routes)
          + f", cpu64 {loss['cpu64']:.8f} (rel err " + ", ".join(
              f"{r} {loss_err[r]:.2e}" for r in routes)
          + "); grad max abs err / max |g| against cpu64: "
          + "; ".join(report) + f" (tolerance for cuda: loss rtol "
          f"{loss_rtol}, grads {STEP_GRAD_REL}"
          + (f", or {cpu_factor}x cpu32's" if cpu_factor else "")
          + f"; CPU steps {secs['cpu32']:.1f} s f32, {secs['cpu64']:.1f} s "
          f"f64)", flush=True)
    if not (loss_err["cuda"] <= loss_rtol
            or loss_err["cuda"] <= factor * loss_err["cpu32"]):
        raise AssertionError(f"step loss CUDA {loss['cuda']} vs float64 "
                             f"{loss['cpu64']}")
    if bad:
        raise AssertionError(f"CUDA gradients off the float64 step: {bad}")


def rank_step_errors(label, rel, scale, top=8):
    """Every parameter's CUDA gradient error / max |g| against float64,
    largest first, beside the CPU float32 route's and their ratio; the
    medians and the count of parameters whose CUDA error is over 10x the
    CPU's. Parameters whose float64 gradient is zero by construction
    (biases that batch norm cancels: max |g| below 1e-9 of the largest)
    are left out and counted."""
    top_g = max(scale.values())
    live = [n for n in rel["cuda"] if scale[n] > 1e-9 * top_g]
    cuda = {n: rel["cuda"][n] for n in live}
    cpu = {n: rel["cpu32"][n] for n in live}
    order = sorted(cuda, key=lambda n: -cuda[n])
    ratio = {n: cuda[n] / max(cpu[n], 1e-300) for n in order}
    print(f"{label}: every parameter's gradient error / max |g| against "
          f"cpu64, largest CUDA first: " + "; ".join(
              f"{n} (max |g| {scale[n]:.2e}) cuda {cuda[n]:.2e} cpu32 "
              f"{cpu[n]:.2e} ({ratio[n]:.1f}x)" for n in order[:top])
          + f"; median cuda {statistics.median(cuda.values()):.2e}, cpu32 "
          f"{statistics.median(cpu.values()):.2e}; {len(order)} parameters "
          f"({len(scale) - len(order)} with a zero gradient left out), "
          f"{sum(r > 10 for r in ratio.values())} over 10x cpu32's; the "
          "largest ratios: " + ", ".join(
              f"{n} {ratio[n]:.1f}x" for n in sorted(
                  ratio, key=lambda n: -ratio[n])[:4]), flush=True)


def sign_pattern(graphs, p):
    """Copies of `graphs` with LapPE sign pattern p of `--rounding`: the
    canonical signs for p = 0, else one random sign per LapPE column of
    each graph in turn, drawn from np.random.default_rng(p)."""
    gs = [copy.copy(g) for g in graphs]
    rng = np.random.default_rng(p)
    for g in gs if p else ():
        g.lap_pe = g.lap_pe * rng.choice(np.float32([-1, 1]),
                                         g.lap_pe.shape[1])
    return gs


def rounding_sweep(graphs, device, n_nodes, n_step, patterns,
                   settings=None):
    """`--rounding`: how far float32 rounding alone moves the SBM model's
    parity step (on the first `n_step` graphs, padded to `n_nodes`) from
    float64, on CUDA and on the CPU, over the canonical LapPE signs and
    `patterns` random sign patterns of the same graphs. At N=1024 the basis
    of SBM_STEP_LOSS_RTOL; with `settings` (the N=2048 slice's), also the
    served logits of one graph, and each CUDA error over the CPU float32
    route's: the basis of LOGITS_CPU32_FACTOR and STEP_CPU32_FACTOR."""
    large = settings is not None
    model_cfg, params = ((LARGE_CFG, LARGE_STEP_PARAMS) if large
                         else (MODEL_CFG, STEP_PARAMS))
    initial = DiffGraphTransformerGenGCNSBM(**model_cfg, **(settings or {}),
                                            seed=1, device=device)
    collate = dict(max_nodes=n_nodes, node_labels=True)
    cfg = TrainConfig(regularization=0.1, sign_flip=False)
    worst = {r: [0.0, 0.0, 0.0] for r in ("cuda", "cpu32", "ratio")}
    for p in range(patterns + 1):
        gs = sign_pattern(graphs, p)
        loss, rel, _, _ = step_errors(initial, gs[:n_step], device, collate,
                                      cfg, params)
        logits = {}
        if large:
            model = DiffGraphTransformerGenGCNSBM(**model_cfg, **settings,
                                                  seed=0, device=device)
            calibrate_batch_norm(model, collate_graphs(gs[:2], **collate),
                                 device)
            pred = Predictor(model, device=device, max_batch=2,
                             node_level=True, collate_kwargs=collate)
            logits = logits_errors(model, gs, collate,
                                   lambda: pred.predict(gs[:2])[0])
        errs = {r: [abs(loss[r] - loss["cpu64"]) / abs(loss["cpu64"]),
                    max(rel[r].values()), logits.get(r, 0.0)]
                for r in ("cuda", "cpu32")}
        errs["ratio"] = [c / max(q, 1e-30) for c, q in
                         zip(errs["cuda"], errs["cpu32"])]
        for r, e in errs.items():
            worst[r] = [max(w, x) for w, x in zip(worst[r], e)]
        line = [f"{r} loss rel err {e[0]:.2e}, grads {e[1]:.2e}"
                + (f", logits {e[2]:.3e}" if large else "")
                for r, e in errs.items() if r != "ratio"]
        if large:
            line.append("cuda/cpu32 loss {:.2f}, grads {:.2f}, logits {:.2f}"
                        .format(*errs["ratio"]))
        print(f"rounding N={n_nodes}: sign pattern "
              f"{p if p else 'canonical'}: " + "; ".join(line), flush=True)
    print(f"rounding N={n_nodes}: worst over the patterns: " + "; ".join(
        f"{'cuda/cpu32' if r == 'ratio' else r} loss {w[0]:.2e}, grads "
        f"{w[1]:.2e}" + (f", logits {w[2]:.3e}" if large else "")
        for r, w in worst.items() if large or r != "ratio")
        + f" (tolerances for cuda: loss {SBM_STEP_LOSS_RTOL}, grads "
        f"{STEP_GRAD_REL}"
        + (f", or {STEP_CPU32_FACTOR}x cpu32's; logits rtol/atol 1e-3, "
           f"or {LOGITS_CPU32_FACTOR}x cpu32's" if large else "") + ")",
        flush=True)


def precision_probe(device):
    """`--precision`: where the card's float32 N=2048 forward and backward
    ("fold") part from the CPU's. Each GraphiT layer is re-run from the
    float64 forward's own inputs cast to float32, on the CPU, on the card
    and on the card with the plain versions (`plain_kernels`), and what it
    computes (its attention output, the FFN's two products, the layer's
    output) is held to the float64 layer's: each step's own rounding, not
    what came before it (max abs err / max |float64|). Then one graph's
    served logits on each route against float64. Then the backward of the
    `--rounding` parity step (its model, one graph) on the canonical LapPE
    signs and on the sign patterns of PROBE_PATTERNS, part by part
    (`backward_probe`), and that step's error under four summation orders
    (`step_spread`). The "r4" setting's filtered layer (the score route:
    its products over the keys in blocks, `ops/cheb.py`) is probed beside
    it, forward and backward."""
    graphs = make_graphs(2, LARGE_N)
    collate = dict(max_nodes=LARGE_N, node_labels=True)
    model = DiffGraphTransformerGenGCNSBM(
        **LARGE_CFG, **LARGE_SETTINGS["fold"], seed=0, device=device)
    # batch norm set by the float64 forward, so that every layer's inputs
    # are the same whatever kernels the card runs (`kernel_ab.py
    # --precision` compares kernel trees)
    ref_model = copy.deepcopy(model).to("cpu", torch.float64)
    calibrate_batch_norm(ref_model, as_float64(
        collate_graphs(graphs[:2], **collate)), "cpu")
    model.load_state_dict(ref_model.state_dict())
    model.eval()
    one = collate_graphs(graphs[:1], **collate)
    layer_inputs = []
    hooks = [layer.register_forward_hook(
        lambda mod, args, kwargs, out: layer_inputs.append((args, kwargs)),
        with_kwargs=True) for layer in ref_model.encoder.layers]
    with torch.inference_mode():
        ref_model(as_float64(one))
    for hk in hooks:
        hk.remove()
    routes = {"cpu64": ("cpu", torch.float64, contextlib.nullcontext),
              "cpu32": ("cpu", torch.float32, contextlib.nullcontext),
              "cuda": (device, torch.float32, contextlib.nullcontext),
              "cuda_plain": (device, torch.float32, plain_kernels)}
    for i, inputs in enumerate(layer_inputs):
        layer_probe(model.encoder.layers[i], inputs, routes,
                    f"precision N={LARGE_N} layer {i}")
    # the "r4" filtered layer (the last) from the same float64 inputs
    r4_kw = dict(**LARGE_CFG, **LARGE_SETTINGS["r4"], device=device)
    model_r4 = DiffGraphTransformerGenGCNSBM(**r4_kw, seed=0)
    model_r4.load_state_dict(model.state_dict())
    last = len(layer_inputs) - 1
    layer_probe(model_r4.encoder.layers[last], layer_inputs[last], routes,
                f"precision N={LARGE_N} r4 filtered layer {last}")
    pred = Predictor(model, device=device, max_batch=2, node_level=True,
                     collate_kwargs=collate)
    errs = logits_errors(model, graphs, collate,
                         lambda: pred.predict(graphs[:2])[0], plain=True)
    print(f"precision N={LARGE_N} logits of one graph "
          f"({graphs[0].num_nodes} nodes) against float64: max abs err "
          f"cuda {errs['cuda']:.3e}, cuda_plain {errs['cuda_plain']:.3e}, "
          f"cpu32 {errs['cpu32']:.3e} (max |logit| {errs['scale']:.3f})",
          flush=True)
    step_model = DiffGraphTransformerGenGCNSBM(
        **LARGE_CFG, **LARGE_SETTINGS["fold"], seed=1, device=device)
    cfg = TrainConfig(regularization=0.1, sign_flip=False)
    step_r4 = DiffGraphTransformerGenGCNSBM(**r4_kw, seed=1)
    for p in PROBE_PATTERNS:
        label = f"N={LARGE_N} pattern {p if p else 'canonical'}"
        one = sign_pattern(graphs, p)[:1]
        backward_probe(step_model, one, collate, cfg, routes, label)
        backward_probe(step_r4, one, collate, cfg, routes, f"{label} r4",
                       names=[f"encoder.layers.{last}"])
        step_spread(step_model, one, device, collate, cfg, LARGE_STEP_PARAMS,
                    label)


def layer_probe(layer, inputs, routes, label):
    """One GraphiT layer re-run from float64 inputs (args, kwargs) on each
    route of `routes` (the first the float64 reference): what it computes
    (its attention output, the FFN's two products, its output) against
    the reference, max abs err / max |float64|, with each "cuda" error
    over "cpu32"'s."""
    args, kwargs = inputs
    f32 = list(routes)[1:]
    steps = ("attention", "ff1", "ff2", "out")
    got = {}
    for route, (dev, dtype, ctx) in routes.items():
        mod = copy.deepcopy(layer).to(dev, dtype)
        seen = []   # what the dropouts see: attn_out, relu(ff1), ff2
        mod.dropout.register_forward_hook(
            lambda m, a, out: seen.append(out))
        cast = [t.to(dev, dtype) if torch.is_tensor(t)
                and t.is_floating_point() else
                t.to(dev) if torch.is_tensor(t) else t for t in args]
        with torch.inference_mode(), ctx():
            out = mod(*cast, **kwargs)[0]
        got[route] = [t.double().cpu() for t in seen + [out]]
    ref = list(routes)[0]
    errs = {r: [float((g - w).abs().max() / w.abs().max())
                for g, w in zip(got[r], got[ref])] for r in f32}
    ratio = [c / max(q, 1e-30) for c, q in zip(errs["cuda"],
                                               errs["cpu32"])]
    print(f"{label}: " + "; ".join(
        f"{st} " + ", ".join(f"{r} {errs[r][k]:.3e}" for r in f32)
        + f" (cuda/cpu32 {ratio[k]:.2f})"
        for k, st in enumerate(steps)), flush=True)
    return errs


# what the backward probe holds to float64 in each part of the model: the
# parameters' gradients by name (the gradients of a part's inputs are held
# too); an encoder layer also FlashGraphiT.backward's five
PROBE_PARAMS = {"layer": ("qkv", "out_proj_kernel", "ff1.weight",
                          "ff2.weight"),
                "encoder.coeff_head": ("gcn_kernel", "coeff_linear.weight"),
                "encoder.cheb_filter": (),
                "encoder.linear_cat": ("weight",),
                "classifier": ("fc1.weight", "fc2.weight")}
FLASH_GRADS = ("dxa", "dcq", "dvw", "dck", "dx")


@contextlib.contextmanager
def record_flash_bwd(store):
    """FlashGraphiT.backward's gradients (dxa, dcq, dvw, dck, dx) of each
    call appended to `store`; the computation is unchanged."""
    inner = fl_mod.flash_bwd

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        store.append(out)
        return out

    fl_mod.flash_bwd = recording
    try:
        yield
    finally:
        fl_mod.flash_bwd = inner


@contextlib.contextmanager
def capture_parts(model, parts):
    """Record, during one forward and backward of `model`, each part's
    inputs and the cotangents of its outputs: parts[name] = dict(args,
    kwargs, grad_in, cot). A part is a submodule by its dotted name, or
    "encoder.cheb_filter", the Chebyshev filter function of the encoder.
    The part hands on views of its outputs, whose hooks see only the
    cotangent from outside it (the "r4" filtered layer returns its
    attention, which it also multiplies by v itself)."""
    def record(name, args, kwargs, out):
        keep = lambda t: t.detach().clone() if torch.is_tensor(t) else t
        entry = dict(args=[keep(a) for a in args],
                     kwargs={k: keep(v) for k, v in kwargs.items()},
                     grad_in=[torch.is_tensor(a) and a.requires_grad
                              for a in args], cot={})
        outs = list(out) if isinstance(out, tuple) else [out]
        for k, t in enumerate(outs):
            if torch.is_tensor(t) and t.requires_grad:
                outs[k] = t.view_as(t)
                outs[k].register_hook(lambda g, k=k: entry["cot"].
                                      __setitem__(k, g.detach().clone()))
        parts[name] = entry
        return tuple(outs) if isinstance(out, tuple) else outs[0]

    hooks = [model.get_submodule(name).register_forward_hook(
        lambda mod, args, kwargs, out, name=name:
        record(name, args, kwargs, out), with_kwargs=True)
        for name in list(parts) if name != "encoder.cheb_filter"]
    inner = feta_mod.cheb_filter_dynamic

    def cheb(*args):
        return record("encoder.cheb_filter", args, {}, inner(*args))

    feta_mod.cheb_filter_dynamic = cheb
    try:
        yield
    finally:
        feta_mod.cheb_filter_dynamic = inner
        for hk in hooks:
            hk.remove()


def rerun_backward(initial, name, entry, device, dtype, ctx):
    """One part's forward and backward from the recorded inputs and
    cotangents, cast to `dtype` on `device`, its copy of the initial
    weights in train mode; returns its gradients (float64, CPU)."""
    cast = lambda t: (t.to(device, dtype) if t.is_floating_point()
                      else t.to(device)) if torch.is_tensor(t) else t
    args = [cast(a).detach().requires_grad_() if rg else cast(a)
            for a, rg in zip(entry["args"], entry["grad_in"])]
    kwargs = {k: cast(v) for k, v in entry["kwargs"].items()}
    if name == "encoder.cheb_filter":
        fn, params = feta_mod.cheb_filter_dynamic, ()
    else:
        fn = copy.deepcopy(initial.get_submodule(name)).to(device, dtype)
        fn.train()
        params = PROBE_PARAMS["layer" if ".layers." in name else name]
    flash = []
    with ctx(), record_flash_bwd(flash):
        out = fn(*args, **kwargs)
        outs = out if isinstance(out, tuple) else (out,)
        cot = sorted(entry["cot"].items())
        torch.autograd.backward([outs[k] for k, _ in cot],
                                [cast(g) for _, g in cot])
    grads = {f"in{k}": a.grad for k, a in enumerate(args)
             if torch.is_tensor(a) and a.grad is not None}
    grads.update((p, fn.get_parameter(p).grad) for p in params)
    if flash:
        grads.update(zip(FLASH_GRADS, flash[-1]))
    return {k: v.detach().double().cpu() for k, v in grads.items()}


def backward_probe(initial, graphs, collate, cfg, routes, label,
                   names=None):
    """Where float32 rounding enters a training step's backward. One step
    of `initial` in float64 on the CPU (Trainer.step, so the loss is the
    step's) records each part's inputs and output cotangents; each part's
    backward is re-run from them on every route of `routes` ({name:
    (device, dtype, context)}, the first the float64 reference) and each
    gradient it produces is held to the reference route's: max abs err /
    max |float64|, the part's own rounding, not what came before it
    (in{k}: the gradient of the part's k-th input). The reference route's
    parameter gradients must equal the float64 step's own. Returns
    {part: {gradient: {route: error}}} and prints one line a part
    with each float32 route's error and, for "cuda", its ratio to
    "cpu32". `names` picks the parts (default: every one)."""
    batch = collate_graphs(graphs, **collate)
    model = copy.deepcopy(initial).to("cpu", torch.float64)
    n_layers = len(model.encoder.layers)
    names = names or [f"encoder.layers.{i}" for i in range(n_layers)] + [
        "encoder.coeff_head", "encoder.cheb_filter", "encoder.linear_cat",
        "classifier"]
    parts = dict.fromkeys(names)
    with capture_parts(model, parts):
        Trainer(model, cfg).step(as_float64(batch))
    ref, *f32 = routes
    errs = {}
    for name in names:
        got = {r: rerun_backward(initial, name, parts[name], *routes[r])
               for r in routes}
        for g in PROBE_PARAMS["layer" if ".layers." in name else name]:
            step = model.get_submodule(name).get_parameter(g).grad
            if not torch.allclose(got[ref][g], step, rtol=1e-9, atol=1e-12):
                raise AssertionError(f"backward probe: {name}.{g} re-run "
                                     "off the float64 step's gradient")
        # dcq is 0 in exact arithmetic (a shift of one query's scores
        # leaves its attention row unchanged): held to max |dck|, the sum
        # of the same ds over the other axis
        scale = {g: float(got[ref]["dck" if g == "dcq" else g].abs().max())
                 for g in got[ref]}
        errs[name] = {
            g: {r: float((got[r][g] - w).abs().max()) / max(scale[g], 1e-300)
                for r in f32}
            for g, w in got[ref].items()}
        ratio = lambda e: (
            f" (cuda/cpu32 {e['cuda'] / max(e['cpu32'], 1e-30):.2f})"
            if "cuda" in e and "cpu32" in e else "")
        print(f"backward {label} {name}: " + "; ".join(
            f"{g} " + ", ".join(f"{r} {e[r]:.3e}" for r in f32) + ratio(e)
            for g, e in errs[name].items()), flush=True)
    return errs


@contextlib.contextmanager
def cpu_threads(n):
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def step_spread(initial, graphs, device, collate, cfg, params, label):
    """How far float32 rounding alone moves the parity step's gradients
    from float64 under four summation orders: CUDA with the kernels, CUDA
    with their plain versions, the CPU with all its threads and with one.
    Prints and returns each route's max over `params` of max abs err /
    max |g| of the float64 step."""
    batch = collate_graphs(graphs, **collate)

    def grads(model, b, ctx):
        with ctx:
            Trainer(model, cfg).step(b)
        return {n: model.get_parameter(n).grad.double().cpu()
                for n in params}

    ref = grads(copy.deepcopy(initial).to("cpu", torch.float64),
                as_float64(batch), contextlib.nullcontext())
    threads = torch.get_num_threads()
    routes = {"cuda": (device, contextlib.nullcontext()),
              "cuda_plain": (device, plain_kernels()),
              f"cpu32 x{threads}": ("cpu", contextlib.nullcontext()),
              "cpu32 x1": ("cpu", cpu_threads(1))}
    errs = {}
    for route, (dev, ctx) in routes.items():
        got = grads(copy.deepcopy(initial).to(dev), batch.to(dev), ctx)
        errs[route] = max(float((got[n] - ref[n]).abs().max())
                          / float(ref[n].abs().max()) for n in params)
    print(f"step spread {label}: grads max abs err / max |g| against "
          "float64: " + ", ".join(f"{r} {e:.3e}" for r, e in errs.items()),
          flush=True)
    return errs


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
    clock = [t0]

    def lap(label):
        """Print the seconds since the previous lap (the script's time
        limit is a budget shared by its phases)."""
        now = time.perf_counter()
        print(f"time: {label} {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    if "--rounding" in sys.argv:
        rounding_sweep(make_graphs()[:2], device, N_NODES, 2, 8)
        rounding_sweep(make_graphs(LARGE_GRAPHS, LARGE_N),
                       device, LARGE_N, 1, 4, LARGE_SETTINGS["fold"])
        return 0
    if "--precision" in sys.argv:
        precision_probe(device)
        return 0
    rows = check_kernels(device)
    rows.update(check_bwd_kernels(device))
    wide = check_kernels(device, d=WIDE_D, shapes=WIDE_SHAPES,
                         dvs=(WIDE_D, 16), fold_shape=False, f64=True)
    wide.update(check_bwd_kernels(device, d=WIDE_D, shapes=WIDE_SHAPES,
                                  dvs=(WIDE_D, 16), f64=True))
    for name, row in wide.items():
        rows[name].update(ms_d128=row["ms"], plain_ms_d128=row["plain_ms"],
                          bound_ms_d128=row["bound_ms"],
                          bound_by_d128=row["bound_by"])
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        row["max_abs_err"])
    rows.update(check_hf_kernels(device))
    rows.update(check_fused_mlp(device))
    rows.update(check_modulation(device))
    rows.update(check_fused_attention(device))
    for name, err in check_unmodulated(device).items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    lap("build and kernel checks")
    profile = "--profile" in sys.argv
    graphs = make_graphs()
    runs = [serve_slice(graphs, device, card, profile=profile),
            train_slice(graphs, device, card, profile=profile)]
    san_graphs = make_san_graphs()
    runs += [san_serve_slice(san_graphs, device, card, profile=profile),
             san_train_slice(san_graphs, device, card, profile=profile)]
    lap("sbm and san phases")
    runs += zinc_slice(device, card, profile=profile)
    lap("zinc phase")
    runs += large_slice(device, card, profile=profile)
    lap("N=2048 phase")
    runs += molhiv_slice(device, card, profile=profile)
    lap("molhiv phase")
    runs += lpe_slice(device, card, profile=profile)
    lap("lpe phase")
    runs += lspe_slice(device, card, profile=profile)
    lap("lspe phase")
    runs += graphit_slice(device, card)
    lap("graphit phase")
    runs += packed_slice(device, card)
    lap("packed phase")
    runs += gckn_slice(device, card)
    lap("gckn phase")
    bf16_rows, bf16_runs = bf16_slice(graphs, device, card)
    runs += bf16_runs
    for name, row in bf16_rows.items():
        rows[name].update(row)
    lap("bf16 phase")
    runs += cli_slice(card)
    lap("cli phase")
    print(f"time: build to the end of the cli phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    pallas = "feta_tmlr_tpu/ops/pallas/"
    meta = {"flash_fwd": ("fwd.cuh", "flash_attention.py:95"),
            "colstat": ("colstat.cu", "flash_attention.py:776"),
            "flash_bwd_q": ("bwd_q.cuh", "flash_attention.py:528"),
            "flash_bwd_k": ("flash_bwd.cu", "flash_attention.py:556"),
            "flash_fwd_hf": ("fwd.cuh", "flash_attention.py:163"),
            "flash_bwd_q_hf": ("bwd_q.cuh", "flash_attention.py:268"),
            "flash_bwd_k_hf": ("flash_hf.cu", "flash_attention.py:310"),
            "fused_mlp_fwd": ("fused_mlp.cu", "fused_mlp.py:58"),
            "fused_mlp_bwd": ("fused_mlp.cu", "fused_mlp.py:70"),
            "modulation_fwd": ("modulation.cu", "modulation.py:30"),
            "modulation_bwd": ("modulation.cu", "modulation.py:53"),
            "fused_attn_fwd": ("fused_attention.cu", "fused_attention.py:60"),
            "fused_attn_bwd": ("fused_attention.cu", "fused_attention.py:85")}
    # launches: the main paths' runs (SBM at N=1024, SAN, ZINC on its
    # three routes, SBM at N=2048 under its three settings, molhiv, the
    # LPE codebase's other nets, the GraphiT baselines and the FeTA
    # options, packed batches and their padded twin, the FeTA + GCKN
    # regressor, the bf16 phase's runs under either policy, and the entry
    # points of the cli phase, serving and training)
    kernels = [dict(name=name, route="cuda",
                    source=f"feta_tmlr_tpu_torch/csrc/{src}",
                    replaces=pallas + line,
                    launches=sum(run[name] for run in runs),
                    max_abs_err=rows[name]["max_abs_err"],
                    ms=rows[name]["ms"], plain_ms=rows[name]["plain_ms"],
                    bound_ms=rows[name]["bound_ms"],
                    bound_by=rows[name]["bound_by"], library_ms=None,
                    **{k: v for k, v in rows[name].items()
                       if k == "bound_f32_ms" or k.endswith("_rate0")
                       or k.endswith("_d128") or "_d16" in k
                       or "_pairs" in k or "bf16" in k
                       or k == "ms_f32_twin"})
               for name, (src, line) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
