"""A/B of the attention kernels across kernel source trees, on one card.

  python3 kernel_ab.py DIR [DIR ...]           time the forwards and passes
  python3 kernel_ab.py --check DIR [DIR ...]   build facts and edge checks
  python3 kernel_ab.py --dck DV DIR [DIR ...]  the key passes' errors
  python3 kernel_ab.py --precision DIR         chip_smoke.py --precision
  python3 kernel_ab.py --fused [--check] DIR [DIR ...]
                                               the same for the fused pair
  python3 kernel_ab.py --fused --times DIR [DIR ...]
                                               its times alone, and bits
  python3 kernel_ab.py --colstat [--check | --times] DIR [DIR ...]
  python3 kernel_ab.py --mlp [--check | --times] DIR [DIR ...]
  python3 kernel_ab.py --modulation [--check | --times] DIR [DIR ...]
                                               the same for colstat, the
                                               fused MLP pair and the
                                               modulation pair

Each DIR holds a copy of `feta_tmlr_tpu_torch/csrc` (a variant, edited or
taken from another commit). The default mode builds every variant's
`flash_fwd`, `flash_bwd` and `flash_hf` libraries side by side (their file
names carry the source hash, so variants do not overwrite each other),
then times the forwards `flash_fwd` and `flash_fwd_hf`, the query passes
`flash_bwd_q` and `flash_bwd_q_hf` and the key passes `flash_bwd_k` and
`flash_bwd_k_hf` at the main paths' shapes (SBM at N=1024, the ZINC batch,
SBM at N=2048) with chip_smoke's `time_ms` (device ms, median of 25 calls)
in two rounds, the second in reverse order. Each variant is held to its
kernel's plain version within chip_smoke's KERNEL_TOL and compared bit for
bit with the first variant. It prints the card's name and power limit,
then one line per variant and shape: `AB <variant> <kernel> B= N= dv=: <ms
round 1> <ms round 2>`. Compare variants only within one run.

`--check` prints each kernel's registers and spills (`nvcc -Xptxas -v`)
and its count of `HMMA.1688.F32.TF32` (`cuobjdump -sass` of a cubin),
then holds each forward and backward pass to its plain version at the
tiles' edge shapes (a tree with the wide rows, `kWideW` in strips.cuh,
also at WIDE_EDGES: D and dv up to 128) (where it misses, the indices of
the misses), two runs bit-identical, the folded forward and query pass bit-equal to the unfolded
ones, and times them at N >= 1024 (median of 10). With more than one DIR,
the first is the reference (the parent tree's `csrc`) and each other DIR
is checked, its forwards' row maximum m held bit-equal to the reference's
unfolded forward's at every forward shape: m is a max of the score, so a
forward that keeps the score's FMA chain keeps it. `--dck` prints each key
pass's max abs error of dvw, dck and dx over max |float64| against the CPU
float32 route's on the same inputs, over 6 seeds at B=1, H=8, N=2048,
D=64 and value width DV, with the max and mean of the ratios. `--precision`
runs chip_smoke's precision probe on DIR's kernels.

`--fused` takes the fused attention pair (`fused_attention.cu`) instead of
the flash kernels: it times `fused_attn_fwd` and `fused_attn_bwd` at the
ZINC batch (B=128, N=48) and at B=32, N=128 (H=8, D=64), held to plain and
compared bit for bit with the first variant, in two rounds (`AB` lines as
above); with `--check`, each DIR's registers, spills and HMMA count of the
fused library, `cudaOccupancyMaxActiveClusters` of both kernels at those
two shapes (where the library exports it), and both kernels against plain
at the clusters' and strips' edges (H of 1, 3, 8, 12, 13; N of 1, 16, 17,
48, 128; D = 20), guard rows in each, two backward runs bit-identical.
`--fused --times` times the pair without holding it to plain (a variant
with a phase removed computes wrong outputs), then says whether each tree
gives the first tree's bits at H of 8, 12, 13 and N of 1, 17, 48, 128.
`--check` without `--fused` runs the flash checks, then the fused ones.

`--colstat` times `colstat` (wq absent and given, the two launches of
`attention_column_gcn_sums`) at the main paths' shapes: SBM at N=1024
(B=4), the `fold` step's B=1, N=2048, the ZINC batch (B=128, N=48) and
B=8, N=200; held to plain, compared bit for bit with the first tree, two
rounds. With `--check`: registers and spills of each tree's library, then
every tree against plain at N of 1, 17, 48, 64, 65, 200 and 2048 (H 8 and
3, D 64 and 20, pe and deg absent or given, wq absent or given, guard
rows), two runs bit-identical; exp(s - m) <= 1 with m from the tree's own
unfolded forward: with se = su = 1 and a one-hot wq, colsum is a row of
exp(s - m), whose maximum must be exactly 1; and (with more than one DIR)
the diagonal bit-equal to the first tree's, whose score is the same FMA
chain. `--times` times the trees without checks. Without `--check` each
tree's registers and spills are printed first.

`--mlp` times `fused_mlp_fwd` (warm, and cold: `time_ms(cold=True)`) and
`fused_mlp_bwd` (warm) at the SAN head's 40,960 rows (d 8, F 2048,
dropout 0.1 and 0) and at 10,007 rows, held to plain and compared with the
first tree, two rounds, and prints each output's error from float64 over
the CPU float32 route's. With `--check`: registers, spills and HMMA count
of every kernel of `fused_mlp` (each `fwd_kernel` and `bwd_kernel`
instantiation); the dropout keep bit's instructions per (row, unit) by
pipe (`hash_sass`: the SASS of a probe kernel that calls the tree's
`Dropout::keep_scale`, less the same kernel without it), the counts that
chip_smoke's HASH_IMAD_OPS and HASH_ALU_OPS take; then each tree's forward
and backward against plain at every MLP_EDGES shape: R of 1, 31 and
10,007, every width bucket (d 8, 16, 32, 64 and mixed widths), F of 520
(not a multiple of a slab) and 2048, dropout 0 and 0.1, two runs
bit-identical; for a tree with the current interface, the forward's and
the backward's dropout masks read back through `chip_smoke.mlp_masks`,
bit-equal to `dropout_keep`, and pre exact on the dyadic inputs: with g
one-hot on 8 rows, dW2 holds those rows' relu(pre) * scale, equal bit for
bit to the float64 value. `--times` times the trees without checks
(variants with a phase removed). A tree whose library lacks
`feta_fused_mlp_fwd_slabs` (the parent's SIMT forward) has its forward
called through its own C interface (`mlp_fwd`).

`--modulation` times `modulation_fwd` and `modulation_bwd` (H=8) at the ZINC
batch (B=128, N=48, padding 11), B=32, N=128, the `r4` setting's request
and step (B=2 and B=1, N=2048) and B=4, N=1024, each warm (`time_ms`) and
cold (`time_ms(cold=True)`: the L2 cache overwritten before every call,
outside the timed events), in two rounds, beside the bound that
`chip_smoke.modulation_cost` counts from the mask; held to plain, compared
bit for bit with the first tree, and (ZINC batch, B=1, N=2048) each
output's error from float64 over the CPU float32 route's. With `--check`:
registers and spills of each tree's library, then each tree against plain
at N of 1, 4, 17, 48, 128, 129, 300, 1990, 2048 and 8200 (past the
register path), H of 1, 3, 8 and 12, pe and degree absent or given, guard
rows, a graph with every node masked, padded queries, and scores at a
4-byte offset (the 4-byte loads at N % 4 == 0): two backward runs
bit-identical, both outputs exactly 0 at every cell with a masked query or
key. `--times` times without checks. The
parent's `modulation.cu` has the same C interface.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import ctypes

import torch

import chip_smoke as cs
from chip_smoke import bwd_inputs, build, fa_mod, fl_mod, time_ms
from feta_tmlr_tpu_torch.ops.kernels import colstat as cs_mod
from feta_tmlr_tpu_torch.ops.kernels import fused_mlp as fm_mod
from feta_tmlr_tpu_torch.ops.kernels import modulation as mod_mod

# (kernel, B, N, padding, dv): each unfolded kernel at the SBM N=1024 batch
# and the ZINC batch, each folded one at the N=2048 training shape, and the
# unfolded forward at N=2048 too (the `stream` and `r4` settings)
SHAPES = tuple((f"flash_{p}", *shape) for p in ("fwd", "bwd_q", "bwd_k")
               for shape in ((4, 1024, 60, 64), (4, 1024, 60, 8),
                             (128, 48, 11, 64), (128, 48, 11, 8))) + (
    ("flash_fwd", 1, 2048, 100, 64),) + tuple(
        (f"flash_{p}_hf", 1, 2048, 100, dv) for p in ("fwd", "bwd_q", "bwd_k")
        for dv in (64, 8))
# `--check`: (kernel, B, H, N, padding, D, dv) at the tiles' edges
EDGES = tuple(("flash_bwd_q", *e) for e in (
    (2, 4, 200, 7, 64, 8), (2, 4, 256, 0, 64, 64), (2, 3, 100, 5, 20, 12),
    (1, 1, 13, 2, 20, 12), (2, 8, 65, 0, 64, 64), (2, 4, 1, 0, 64, 8),
    (128, 8, 48, 11, 64, 64), (4, 8, 1024, 60, 64, 64),
    (1, 8, 2048, 100, 64, 64))) + tuple(("flash_bwd_q_hf", *e) for e in (
        (2, 4, 200, 7, 64, 8), (2, 8, 256, 0, 64, 64),
        (2, 3, 100, 5, 20, 12), (1, 1, 13, 2, 20, 12), (1, 8, 9, 0, 64, 8),
        (128, 8, 48, 11, 64, 64), (1, 8, 2048, 100, 64, 64),
        (2, 8, 1990, 9, 64, 8), (2, 6, 100, 5, 64, 16),
        (2, 5, 70, 3, 40, 24))) + (
    ("flash_bwd_k", 4, 8, 1024, 60, 64, 64),
    ("flash_bwd_k", 2, 3, 100, 5, 20, 12),
    ("flash_bwd_k_hf", 1, 8, 2048, 100, 64, 64),
    ("flash_bwd_k_hf", 1, 3, 257, 4, 20, 12))
# the forwards, each shape through both (B, H, N, padding, D, dv): chip_smoke's
# CHECK_SHAPES and HF_SHAPES at dv 64 and 8, then the 16-query strips' and
# 32-key tiles' edges: N of 1, 13, 65, 200, 257 and 1990, D = 20 with
# dv = 12, H of 1 and 3
FWD_EDGES = tuple((b, 8, n, pad, 64, dv)
                  for b, n, pad in cs.CHECK_SHAPES + cs.HF_SHAPES
                  for dv in (64, 8)) + (
    (2, 4, 1, 0, 64, 8), (1, 1, 13, 2, 20, 12), (2, 3, 65, 0, 64, 64),
    (2, 3, 200, 7, 20, 12), (1, 3, 257, 4, 20, 12), (1, 1, 1990, 9, 64, 8),
    (2, 8, 33, 1, 64, 8))
# the unfolded kernels' wide rows (csrc/strips.cuh, D or dv over 64):
# (kernel, B, H, N, padding, D, dv) at the molhiv width D = 128 with dv 128
# (two value chunks) and 16 (the filtered layer), D = 100 (a K edge inside
# the second chunk), D = 70 (4-byte staging), N of 1, 13, 65, 200 and 1024
WIDE_EDGES = tuple((name, *e) for name in ("flash_fwd", "flash_bwd_q",
                                           "flash_bwd_k") for e in (
    (4, 8, 1024, 60, 128, 128), (2, 8, 200, 9, 128, 16),
    (2, 3, 65, 3, 100, 100), (1, 1, 13, 2, 70, 70), (2, 4, 1, 0, 128, 128),
    (2, 8, 33, 1, 128, 16), (1, 2, 130, 5, 72, 40)))
LIBS = ("flash_fwd", "flash_bwd", "flash_hf")
FUSED_LIBS = ("fused_attention",)
# `--fused --check`: (B, H, N, padding, D): clusters of 8, 1, 3, 6 (two
# heads a CTA) and 1 (13 heads in one CTA); N of 1, 16, 17 (past one
# strip), 48 and 128; D = 20 (the K edge); then the A/B shapes
FUSED_EDGES = ((2, 8, 48, 5, 64), (2, 1, 17, 2, 64), (2, 3, 16, 0, 20),
               (2, 12, 128, 9, 64), (2, 13, 48, 3, 20), (3, 8, 1, 0, 64),
               (2, 8, 128, 17, 20), (3, 3, 128, 0, 64), (2, 1, 1, 0, 20)) + \
    tuple((b, 8, n, pad, 64) for b, n, pad in cs.FUSED_SHAPES)


def use(src: Path) -> None:
    """Point the kernel build and the wrappers at one variant's sources."""
    build.CSRC = src
    build._libs.clear()
    fl_mod._fns.clear()
    fa_mod._fns.clear()
    fm_mod._fns.clear()
    mod_mod._fns.clear()
    cs_mod._fns.clear()


def build_all(dirs, libs=LIBS) -> None:
    """One nvcc per distinct library of the variants, all started
    together."""
    started, seen = [], set()
    for d in dirs:
        use(d)
        for name in libs:
            path = build._lib_path(name)
            started.append((name, None if path in seen else
                            build._start(name)))
            seen.add(path)
    for name, job in started:
        build._finish(name, job)


def plain_of(name):
    return (fl_mod.flash_fwd_plain if "fwd" in name
            else fl_mod.flash_bwd_q_plain if "_q" in name
            else fl_mod.flash_bwd_k_plain)


def operands(name, args):
    """A kernel's operands of `bwd_inputs`' (a forward takes the first 10)."""
    return args[:10] if "fwd" in name else args


def ab(dirs, dev) -> int:
    inputs = {s: operands(s[0], bwd_inputs(s[1] + s[2] + s[4] + 1, s[1], 8,
                                           s[2], 64, s[4], s[3], dev)[0])
              for s in SHAPES}
    times, first = {}, {}
    for rnd, order in enumerate((dirs, dirs[::-1])):
        for d in order:
            use(d)
            for s in SHAPES:
                fn = getattr(fl_mod, s[0])
                with torch.inference_mode():
                    times.setdefault((d.name, s), []).append(
                        time_ms(lambda: fn(*inputs[s])))
                    if rnd:
                        continue
                    got = fn(*inputs[s])
                    want = plain_of(s[0])(*inputs[s])
                    for g, w in zip(got, want):
                        torch.testing.assert_close(g, w, **cs.KERNEL_TOL)
                    if s not in first:
                        first[s] = (d.name, [t.clone() for t in got])
                    else:
                        same = all(torch.equal(a, b)
                                   for a, b in zip(got, first[s][1]))
                        print(f"{d.name} {s[0]} B={s[1]} N={s[2]} dv={s[4]}"
                              f" bit-equal to {first[s][0]}: {same}",
                              flush=True)
    for (name, s), ts in times.items():
        print(f"AB {name:12s} {s[0]:15s} B={s[1]:3d} N={s[2]:4d} "
              f"dv={s[4]:2d}: " + " ".join(f"{t:.4f}" for t in ts))
    return 0


def build_facts(src: Path, libs=LIBS) -> None:
    """Registers and spills per kernel, and its HMMA.1688.F32.TF32
    count, for each library of `src`."""
    out_dir = build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = Path(build._nvcc())
    for name in libs:
        cubin = out_dir / f"{name}-check.cubin"
        res = subprocess.run(
            [str(nvcc), *build.NVCC_FLAGS[:4], "-cubin",
             "-Xptxas", "-v", "-o", str(cubin), str(src / f"{name}.cu")],
            capture_output=True, text=True)
        log = (res.stdout + res.stderr).splitlines()
        if res.returncode:
            raise RuntimeError("\n".join(log))
        for line in log:
            if re.search(r"Compiling entry|registers|spill", line):
                print(f"ptxas {name}: {line.strip()}")
        sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass",
                               str(cubin)], capture_output=True,
                              text=True, check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                counts[fn] = 0
            elif fn and "HMMA.1688.F32.TF32" in line:
                counts[fn] += 1
        for fn, n in counts.items():
            print(f"sass {name}: {fn} HMMA.1688.F32.TF32 {n}")


# The dropout keep bit of one (row, unit) of a tree's fused_mlp.cu in a
# probe kernel on a loaded row key and unit: the backward's
# (`Dropout::keep_scale`: the hash, its compare and the select of the
# scale) and, where the tree has it, the forward's (`Dropout::keep_p` and
# the select of h or 0); the base adds the two values instead. Their loads
# and stores are the same, so their SASS differ by the keep bit's
# instructions less the base's one FADD.
HASH_PROBE = r"""
#include "{src}"
__global__ void keep_probe(const uint2* in, float* out, Dropout drop) {{
  const uint2 v = in[threadIdx.x];
  out[threadIdx.x] = drop.keep_scale(v.x, (int)v.y);
}}
__global__ void base_probe(const uint2* in, float* out, Dropout drop) {{
  const uint2 v = in[threadIdx.x];
  out[threadIdx.x] = __uint_as_float(v.x) + __uint_as_float(v.y);
}}
"""
FWD_HASH_PROBE = r"""
__global__ void keep_p_probe(const uint2* in, float* out, Dropout drop) {{
  const uint2 v = in[threadIdx.x];
  out[threadIdx.x] = drop.keep_p(v.x, v.y) ? __uint_as_float(v.x) : 0.f;
}}
"""
# opcodes (with their first modifier) that sm_90 issues to the FMA pipe
# (integer multiplies) and to the INT32 lanes; the hash makes no address
# and moves nothing, so ADDRESS (64-bit addresses, moves) is left out
FMA_PIPE = ("IMAD", "IMAD.HI", "IMUL")
ALU_PIPE = ("LOP3.LUT", "SHF.R", "SHF.L", "IADD3", "ISETP.GE", "ISETP.GT",
            "ISETP.LT", "ISETP.LE", "ISETP.NE", "ISETP.EQ", "SEL", "FSEL",
            "PRMT", "IMNMX", "VIADD", "PLOP3.LUT")
ADDRESS = ("LEA", "LEA.HI", "IMAD.WIDE", "IMAD.MOV", "MOV", "IMAD.SHL",
           "IMAD.IADD")


def sass_opcodes(cubin: Path, nvcc: Path, names) -> dict:
    """{function: {opcode and its first modifier: count}} of the cubin's
    functions whose names hold one of `names`; prints their SASS."""
    sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass",
                           str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    ops, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = next((n for n in names if n in m.group(1)), None)
            if fn:
                ops[fn] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*(?:\.[A-Z][A-Z0-9_]*)?)", line)
        if fn and m and m.group(1) != "NOP":
            ops[fn][m.group(1)] = ops[fn].get(m.group(1), 0) + 1
            print(f"sass {fn}: {line.split(';')[0].strip()}")
    return ops


def hash_sass(src: Path) -> None:
    """The keep bit's instructions per (row, unit), from the SASS of
    HASH_PROBE (and FWD_HASH_PROBE where the tree has `keep_p`): each
    opcode's count in a keep probe less base_probe, summed by pipe
    (FMA_PIPE, ALU_PIPE, other: the base's FADD), ADDRESS left out."""
    out_dir = build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = Path(build._nvcc())
    text = (src / "fused_mlp.cu").read_text()
    probes = {"keep_probe": "keep bit per (row, unit)"}
    code = HASH_PROBE
    if "keep_p(" in text:
        probes["keep_p_probe"] = "forward keep bit per (row, unit)"
        code += FWD_HASH_PROBE
    probe = out_dir / f"hash_probe-{src.name}.cu"
    probe.write_text(code.format(src=(src / "fused_mlp.cu").resolve()))
    cubin = probe.with_suffix(".cubin")
    subprocess.run([str(nvcc), *build.NVCC_FLAGS[:4], "-cubin", "-o",
                    str(cubin), str(probe)], check=True)
    ops = sass_opcodes(cubin, nvcc, (*probes, "base_probe"))
    base = ops["base_probe"]
    for name, what in probes.items():
        keep = ops[name]
        diff = {o: keep.get(o, 0) - base.get(o, 0) for o in {*keep, *base}}
        diff = {o: n for o, n in sorted(diff.items()) if n}
        by = {"FMA pipe": 0, "INT32 lanes": 0, "other": 0}
        for o, n in diff.items():
            if o not in ADDRESS:
                by["FMA pipe" if o in FMA_PIPE else "INT32 lanes"
                   if o in ALU_PIPE else "other"] += n
        print(f"sass hash {src.name}: {what} "
              + ", ".join(f"{k} {n}" for k, n in by.items()) + " ("
              + " ".join(f"{o} {n:+d}" for o, n in diff.items()) + "); "
              f"{name} " + " ".join(f"{o} {n}" for o, n in sorted(
                  keep.items())), flush=True)


def misses(got, want):
    """Each output's max error against the plain version and, where one
    misses KERNEL_TOL, the indices of the misses: (texts, failures)."""
    msg, bad = [], 0
    for o, (g, w) in enumerate(zip(got, want)):
        err = (g - w).abs()
        ok = bool(torch.isfinite(g).all()) and torch.allclose(
            g, w, **cs.KERNEL_TOL)
        msg.append(f"out{o} max err {float(err.max()):.3e}")
        if ok:
            continue
        bad += 1
        miss = (err > cs.KERNEL_TOL["atol"] + cs.KERNEL_TOL["rtol"]
                * w.abs()) | ~torch.isfinite(g)
        at = miss.nonzero()
        msg.append(f"MISS {len(at)} of {miss.numel()}, first at "
                   f"{at[:8].tolist()}, each axis's indices "
                   + str([sorted(set(at[:, i].tolist()))[:16]
                          for i in range(at.shape[1])]))
    return msg, bad


def edge_inputs(cache, shape, dev):
    """`bwd_inputs`' operands at (B, H, N, padding, D, dv), made once."""
    if shape not in cache:
        b, h, n, pad, d, dv = shape
        cache[shape] = bwd_inputs(b + n + dv + 1, b, h, n, d, dv, pad, dev,
                                  guard_rows=min(n, 8))[0]
    return cache[shape]


def reference_m(ref: Path, dev):
    """The reference tree's unfolded forward's m at each FWD_EDGES shape."""
    use(ref)
    cache = {}
    with torch.inference_mode():
        return {e: fl_mod.flash_fwd(*edge_inputs(cache, e, dev)[:10])[1]
                for e in FWD_EDGES}


def check(src: Path, dev, ref_m=None) -> int:
    build_facts(src)
    use(src)
    bad, cache = 0, {}
    twins = {"flash_bwd_q_hf": fl_mod.flash_bwd_q,
             "flash_fwd_hf": fl_mod.flash_fwd}
    cases = EDGES + tuple((name, *e) for e in FWD_EDGES
                          for name in ("flash_fwd", "flash_fwd_hf"))
    if (src / "strips.cuh").read_text().count("kWideW"):
        cases += WIDE_EDGES
    for name, *shape in cases:
        b, h, n, pad, d, dv = shape
        args = operands(name, edge_inputs(cache, tuple(shape), dev))
        fn = getattr(fl_mod, name)
        with torch.inference_mode():
            got, again = fn(*args), fn(*args)
            want = plain_of(name)(*args)
            twin = twins[name](*args) if name in twins else ()
            torch.cuda.synchronize()
        msg = [f"bit-identical {all(map(torch.equal, got, again))}"]
        bad += not all(map(torch.equal, got, again))
        if twin:
            equal = all(map(torch.equal, got, twin))
            msg.append(f"bit-equal to the unfolded kernel {equal}")
            bad += not equal
        if ref_m is not None and "fwd" in name and tuple(shape) in ref_m:
            equal = torch.equal(got[1], ref_m[tuple(shape)])
            msg.append(f"m bit-equal to the reference's {equal}")
            bad += not equal
        text, n_bad = misses(got, want)
        bad += n_bad
        t = time_ms(lambda: fn(*args), reps=10) if n >= 1024 else None
        print(f"{name} B={b} H={h} N={n} D={d} dv={dv}: "
              + "; ".join(msg + text)
              + (f"; {t:.4f} ms" if t is not None else ""), flush=True)
    print(f"check {src}: {bad} failures")
    return 1 if bad else 0


def fused_pair(args, g):
    """Both fused kernels' outputs on `fused_inputs`' operands, the
    backward twice: ([out, dxa, dx, dcq, dck, dc0, dvw], the second
    backward's)."""
    ops, vw = args
    fwd = fa_mod.fused_attn_fwd(vw=vw, **ops)
    bwd = fa_mod.fused_attn_bwd(vw=vw, g=g, **ops)
    return [fwd, *bwd], list(fa_mod.fused_attn_bwd(vw=vw, g=g, **ops))


def fused_plain(args, g):
    ops, vw = args
    return [fa_mod.fused_attn_fwd_plain(vw=vw, **ops),
            *fa_mod.fused_attn_bwd_plain(vw=vw, g=g, **ops)]


def fused_case(shape, dev):
    b, h, n, pad, d = shape
    ops, vw, g = cs.fused_inputs(b + n + d, b, h, n, d, pad, dev)
    return (ops, vw), g


def ab_fused(dirs, dev) -> int:
    shapes = [(b, 8, n, pad, 64) for b, n, pad in cs.FUSED_SHAPES]
    inputs = {s: fused_case(s, dev) for s in shapes}
    times, first = {}, {}
    for rnd, order in enumerate((dirs, dirs[::-1])):
        for d in order:
            use(d)
            for s in shapes:
                (ops, vw), g = inputs[s]
                fns = {"fused_attn_fwd":
                       lambda: fa_mod.fused_attn_fwd(vw=vw, **ops),
                       "fused_attn_bwd":
                       lambda: fa_mod.fused_attn_bwd(vw=vw, g=g, **ops)}
                with torch.inference_mode():
                    for name, fn in fns.items():
                        times.setdefault((d.name, name, s), []).append(
                            time_ms(fn))
                    if rnd:
                        continue
                    got, _ = fused_pair(*inputs[s])
                    want = fused_plain(*inputs[s])
                    for gt, w in zip(got, want):
                        torch.testing.assert_close(gt, w, **cs.KERNEL_TOL)
                    if s not in first:
                        first[s] = (d.name, [t.clone() for t in got])
                    else:
                        same = all(torch.equal(a, b)
                                   for a, b in zip(got, first[s][1]))
                        print(f"{d.name} fused pair B={s[0]} N={s[2]} "
                              f"bit-equal to {first[s][0]}: {same}",
                              flush=True)
    for (name, kern, s), ts in times.items():
        print(f"AB {name:12s} {kern:15s} B={s[0]:3d} N={s[2]:4d} "
              f"D={s[4]:2d}: " + " ".join(f"{t:.4f}" for t in ts))
    return 0


def times_fused(dirs, dev) -> int:
    shapes = [(b, 8, n, pad, 64) for b, n, pad in cs.FUSED_SHAPES]
    inputs = {s: fused_case(s, dev) for s in shapes}
    times = {}
    for order in (dirs, dirs[::-1]):
        for d in order:
            use(d)
            for s in shapes:
                (ops, vw), g = inputs[s]
                with torch.inference_mode():
                    times.setdefault((d.name, "fwd", s), []).append(time_ms(
                        lambda: fa_mod.fused_attn_fwd(vw=vw, **ops)))
                    times.setdefault((d.name, "bwd", s), []).append(time_ms(
                        lambda: fa_mod.fused_attn_bwd(vw=vw, g=g, **ops)))
    for (name, kern, s), ts in times.items():
        print(f"T {name:8s} {kern} B={s[0]:3d} N={s[2]:3d}: "
              + " ".join(f"{t:.4f}" for t in ts), flush=True)
    for b, n, pad in cs.FUSED_SHAPES + ((2, 17, 2), (2, 1, 0)):
        for h in (8, 12, 13):
            args, g = fused_case((b, h, n, pad, 64), dev)
            outs = []
            for d in dirs:
                use(d)
                with torch.inference_mode():
                    outs.append(fused_pair(args, g)[0])
            for d, got in zip(dirs[1:], outs[1:]):
                print(f"bits {d.name} B={b} H={h} N={n}: equal to "
                      f"{dirs[0].name} {all(map(torch.equal, got, outs[0]))}",
                      flush=True)
    return 0


def fused_occupancy(src: Path) -> None:
    """cudaOccupancyMaxActiveClusters of both fused kernels at the A/B
    shapes, where `src`'s library exports it."""
    use(src)
    lib = build.load("fused_attention")
    if not hasattr(lib, "feta_fused_attn_max_clusters"):
        print(f"occupancy {src}: no cluster launch in this library")
        return
    fn = lib.feta_fused_attn_max_clusters
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    for b, n, _ in cs.FUSED_SHAPES:
        c = fa_mod.cluster_size(8)
        print(f"occupancy {src.name} B={b} H=8 N={n} D=64: clusters of {c}, "
              f"at most {fn(0, b, 8, n, 64)} (forward) and "
              f"{fn(1, b, 8, n, 64)} (backward) active at once, "
              f"{b} launched", flush=True)


def check_fused(src: Path, dev) -> int:
    build_facts(src, FUSED_LIBS)
    fused_occupancy(src)
    use(src)
    bad = 0
    lib = build.load("fused_attention")
    if hasattr(lib, "feta_fused_attn_cluster"):
        lib.feta_fused_attn_cluster.argtypes = [ctypes.c_int]
        wrong = [h for h in range(1, 17) if lib.feta_fused_attn_cluster(h)
                 != fa_mod.cluster_size(h)]
        print(f"cluster sizes of H = 1 .. 16 as cluster_size: {not wrong}")
        bad += bool(wrong)
    for shape in FUSED_EDGES:
        b, h, n, pad, d = shape
        args, g = fused_case(shape, dev)
        with torch.inference_mode():
            got, again = fused_pair(args, g)
            want = fused_plain(args, g)
            torch.cuda.synchronize()
        same = all(map(torch.equal, got[1:], again))
        bad += not same
        text, n_bad = misses(got, want)
        bad += n_bad
        print(f"fused pair B={b} H={h} N={n} D={d} (clusters of "
              f"{fa_mod.cluster_size(h)}): bwd bit-identical {same}; "
              + "; ".join(text), flush=True)
    print(f"check fused {src}: {bad} failures")
    return 1 if bad else 0


def dck(dv: int, dirs, dev) -> int:
    err = lambda got, want: float((got.double().cpu() - want).abs().max()
                                  / want.abs().max())
    outs, ratios = ("dvw", "dck", "dx"), {}
    for seed in range(6):
        args, _, _ = bwd_inputs(100 + seed, 1, 8, 2048, 64, dv, 100, dev)
        cpu = [t.cpu() if torch.is_tensor(t) else t for t in args]
        with torch.inference_mode():
            ref = fl_mod.flash_bwd_k_plain(*[
                t.double() if torch.is_tensor(t) else t for t in cpu])
            e_cpu = [err(a, w) for a, w in
                     zip(fl_mod.flash_bwd_k_plain(*cpu), ref)]
        for d in dirs:
            use(d)
            for name in ("flash_bwd_k", "flash_bwd_k_hf"):
                with torch.inference_mode():
                    got = getattr(fl_mod, name)(*args)
                e = [err(a, w) for a, w in zip(got, ref)]
                ratios.setdefault((d.name, name), []).append(
                    [x / y for x, y in zip(e, e_cpu)])
                print(f"seed {seed} {d.name} {name}: " + ", ".join(
                    f"{o} {x:.3e} (cpu32 {y:.3e}, {x / y:.2f})"
                    for o, x, y in zip(outs, e, e_cpu)), flush=True)
    for (dn, name), v in ratios.items():
        t = torch.tensor(v)
        print(f"DCK dv={dv} {dn} {name}: over cpu32 max " + " ".join(
            f"{o} {m:.2f}" for o, m in zip(outs, t.max(0).values.tolist()))
            + ", mean " + " ".join(
                f"{o} {m:.2f}" for o, m in zip(outs, t.mean(0).tolist())))
    return 0



# ------------------------------------------------------------- colstat

# (B, N, padding) of the A/B: SBM at N=1024 (B=4), the `fold` step's N=2048,
# the ZINC batch and a ragged N=200
COLSTAT_SHAPES = ((4, 1024, 60), (1, 2048, 100), (128, 48, 11), (8, 200, 9))
# `--colstat --check`: (B, H, N, padding, D, pe given, deg given)
COLSTAT_EDGES = ((2, 8, 1, 0, 64, True, True), (2, 3, 17, 2, 20, True, True),
                 (128, 8, 48, 11, 64, True, True),
                 (2, 8, 64, 0, 64, False, True),
                 (2, 3, 65, 1, 64, True, True), (8, 8, 200, 9, 64, True, True),
                 (2, 3, 130, 5, 20, True, False),
                 (2, 8, 1024, 60, 64, False, False),
                 (1, 8, 2048, 100, 64, True, True))


def colstat_inputs(seed, b, h, n, d, pad, dev, pe=True, deg=True):
    """colstat's operands: the attention inputs with pe zero on graph 0's
    first 4 query rows (the |su/se| <= 1e-9 branch), the plain forward's
    row statistics, a random wq, and vw for the forward."""
    ops, vw = cs.attention_inputs(seed, b, h, n, d, 8, pad, dev)
    ops["pe"][0, :4] = 0.0
    ops["pe"] = ops["pe"] if pe else None
    ops["deg"] = ops["deg"] if deg else None
    _, m, se, su = fl_mod.flash_fwd_plain(vw=vw, **ops)
    wq = torch.rand(se.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(seed))
    return ops, dict(m=m, se=se, su=su), wq, vw


def ab_colstat(dirs, dev, checks=True) -> int:
    inputs = {s: colstat_inputs(sum(s), s[0], 8, s[1], 64, s[2], dev)
              for s in COLSTAT_SHAPES}
    times, first = {}, {}
    for rnd, order in enumerate((dirs, dirs[::-1])):
        for d in order:
            use(d)
            for s in COLSTAT_SHAPES:
                ops, stats, wq, _ = inputs[s]
                with torch.inference_mode():
                    for w, tag in ((None, "wq=1"), (wq, "wq")):
                        fn = lambda: cs_mod.colstat(**ops, **stats, wq=w)
                        times.setdefault((d.name, tag, s), []).append(
                            time_ms(fn))
                        if rnd or not checks:
                            continue
                        got = fn()
                        want = cs_mod.colstat_plain(**ops, **stats, wq=w)
                        for g_, w_ in zip(got, want):
                            torch.testing.assert_close(g_, w_,
                                                       **cs.KERNEL_TOL)
                        key = (tag, s)
                        if key not in first:
                            first[key] = (d.name, [t.clone() for t in got])
                        else:
                            print(f"{d.name} colstat {tag} B={s[0]} N={s[1]}"
                                  f" bit-equal to {first[key][0]}: colsum "
                                  f"{torch.equal(got[0], first[key][1][0])}"
                                  f", diag "
                                  f"{torch.equal(got[1], first[key][1][1])}",
                                  flush=True)
    for (name, tag, s), ts in times.items():
        print(f"AB {name:12s} colstat {tag:5s} B={s[0]:3d} N={s[1]:4d}: "
              + " ".join(f"{t:.4f}" for t in ts))
    return 0


def exp_bound(ops, vw, dev):
    """Rows of exp(s - m) from the current tree's colstat, m from its own
    unfolded forward: se = su = 1, pe and deg absent and wq one-hot at row
    i make colsum[b, h] = exp(s[i, :] - m[i]) * kmask. Returns the number
    of rows checked and of rows whose maximum is not exactly 1 or that
    exceed 1 anywhere."""
    _, m, _, _ = fl_mod.flash_fwd(vw=vw, **ops)
    plain_ops = dict(ops, pe=None, deg=None)
    ones = torch.ones_like(m)
    mask = ops["mask"]
    n = mask.shape[1]
    checked = bad = 0
    for i in sorted({0, n // 2, n - 1}):
        wq = torch.zeros_like(m)
        wq[:, :, i] = 1.0
        row, _ = cs_mod.colstat(**plain_ops, m=m, se=ones, su=ones, wq=wq)
        real = mask[:, i] > 0
        for b in real.nonzero().flatten().tolist():
            r = row[b]                                   # [H, N]
            checked += r.shape[0]
            bad += int(((r.amax(-1) != 1.0) | (r > 1.0).any(-1)).sum())
    return checked, bad


def check_colstat(dirs, dev) -> int:
    bad = 0
    ref = {}
    for d in dirs:
        build_facts(d, ("colstat",))
        use(d)
        for e in COLSTAT_EDGES:
            b, h, n, pad, dd, pe, deg = e
            ops, stats, wq, vw = colstat_inputs(b + n + dd, b, h, n, dd, pad,
                                                dev, pe, deg)
            msg = []
            with torch.inference_mode():
                for w, tag in ((None, "wq=1"), (wq, "wq")):
                    got = cs_mod.colstat(**ops, **stats, wq=w)
                    again = cs_mod.colstat(**ops, **stats, wq=w)
                    want = cs_mod.colstat_plain(**ops, **stats, wq=w)
                    torch.cuda.synchronize()
                    same = all(map(torch.equal, got, again))
                    bad += not same
                    text, n_bad = misses(got, want)
                    bad += n_bad
                    msg.append(f"{tag}: bit-identical {same}; "
                               + "; ".join(text))
                    if (e, tag) not in ref:
                        ref[e, tag] = (d.name, got[1].clone())
                    else:
                        equal = torch.equal(got[1], ref[e, tag][1])
                        bad += not equal
                        msg.append(f"diag bit-equal to {ref[e, tag][0]}'s "
                                   f"{equal}")
                checked, n_exp = exp_bound(ops, vw, dev)
            bad += n_exp
            print(f"colstat {d.name} B={b} H={h} N={n} pad~{pad} D={dd} "
                  f"pe={pe} deg={deg}: " + "; ".join(msg)
                  + f"; exp(s - m) <= 1 with maximum exactly 1 on "
                  f"{checked - n_exp} of {checked} rows", flush=True)
    print(f"check colstat: {bad} failures")
    return 1 if bad else 0


# ------------------------------------------------------------- fused MLP

# (rows, d_in, F, d_out, rate) of the A/B
MLP_AB = ((cs.SAN_ROWS, 8, 2048, 8, 0.1), (cs.SAN_ROWS, 8, 2048, 8, 0.0),
          (10007, 8, 2048, 8, 0.1))
# `--mlp --check`: every width bucket, F not a multiple of a slab
MLP_EDGES = ((1, 8, 520, 8, 0.1), (31, 8, 2048, 8, 0.0),
             (10007, 8, 2048, 8, 0.1), (257, 3, 100, 5, 0.3),
             (300, 16, 520, 16, 0.1), (31, 12, 2048, 16, 0.0),
             (1000, 32, 520, 32, 0.1), (10007, 20, 520, 8, 0.1),
             (500, 64, 520, 64, 0.1), (64, 40, 70, 64, 0.0),
             (1, 64, 2048, 64, 0.0))


def mlp_fwd(x, w1, b1, w2, b2, rate, seed):
    """fused_mlp_fwd through the current tree's library: the wrapper, or
    for a library without `feta_fused_mlp_fwd_slabs` (the parent's SIMT
    forward) its own C interface."""
    lib = build.load("fused_mlp")
    if hasattr(lib, "feta_fused_mlp_fwd_slabs"):
        return fm_mod.fused_mlp_fwd(x, w1, b1, w2, b2, rate, seed)
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn = lib.feta_fused_mlp_fwd
    fn.argtypes = [p] * 6 + [i] * 5 + [u, u, ctypes.c_float, p]
    r, din = x.shape
    f, dout = w2.shape
    y = torch.empty((r, dout), device=x.device)
    err = fn(*(t.data_ptr() for t in (x, w1, b1, w2, b2, y)), r, din, f,
             dout, *fm_mod._dropout_args(rate, seed),
             torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"fused_mlp_fwd (parent interface): {err}")
    return y


def ratio_text(got, want, cpu, outs):
    """Each output's max abs error from the float64 outputs `want` over
    the CPU float32 route's `cpu` (chip_smoke.cpu32_ratios' statistic)."""
    e = lambda a, w: float((a.cpu().double() - w.cpu()).abs().max())
    return " ".join(f"{o} {e(g_, w_) / e(c_, w_):.2f}"
                    for o, g_, w_, c_ in zip(outs, got, want, cpu))


BWD_OUTS = ("dx", "dW1", "db1", "dW2", "db2")


def ab_mlp(dirs, dev, checks=True) -> int:
    """The forward (warm and cold) and the backward (warm) of each tree at
    MLP_AB, two rounds; with `checks`, each held to plain, its error from
    float64 over the CPU float32 route's, and compared bit for bit with
    the first tree."""
    inputs = {s: cs.mlp_inputs(s[0] + s[2], *s[:4], dev) for s in MLP_AB}
    refs = {}
    if checks:   # float64 on the card, float32 on the CPU
        for s in MLP_AB:
            x, w1, b1, w2, b2, g = inputs[s]
            with torch.no_grad():
                refs[s, "fwd"] = (
                    [fm_mod.fused_mlp_plain(
                        *(t.double() for t in (x, w1, b1, w2, b2)), s[4], 7)],
                    [fm_mod.fused_mlp_plain(
                        *(t.cpu() for t in (x, w1, b1, w2, b2)), s[4], 7)])
                refs[s, "bwd"] = (fm_mod.fused_mlp_bwd_plain(
                    *(t.double() for t in (x, w1, b1, w2, g)), s[4], 7),
                    fm_mod.fused_mlp_bwd_plain(
                        *(t.cpu() for t in (x, w1, b1, w2, g)), s[4], 7))
    times, first = {}, {}
    for rnd, order in enumerate((dirs, dirs[::-1])):
        for d in order:
            use(d)
            for s in MLP_AB:
                x, w1, b1, w2, b2, g = inputs[s]
                calls = {
                    "fwd": (lambda: [mlp_fwd(x, w1, b1, w2, b2, s[4], 7)],
                            lambda: [fm_mod.fused_mlp_plain(
                                x, w1, b1, w2, b2, s[4], 7)], ("y",)),
                    "bwd": (lambda: fm_mod.fused_mlp_bwd(x, w1, b1, w2, g,
                                                         s[4], 7),
                            lambda: fm_mod.fused_mlp_bwd_plain(
                                x, w1, b1, w2, g, s[4], 7), BWD_OUTS)}
                with torch.no_grad():
                    fwd = calls["fwd"][0]
                    times.setdefault((d.name, "fwd", s), []).append(
                        time_ms(fwd))
                    times.setdefault((d.name, "fwd cold", s), []).append(
                        time_ms(fwd, cold=True))
                    times.setdefault((d.name, "bwd", s), []).append(
                        time_ms(calls["bwd"][0]))
                    if rnd or not checks:
                        continue
                    for which, (fn, plain, outs) in calls.items():
                        got, want = fn(), plain()
                        for g_, w_ in zip(got, want):
                            torch.testing.assert_close(g_, w_,
                                                       **cs.KERNEL_TOL)
                        tag = f"{d.name} fused_mlp_{which} R={s[0]} " \
                              f"rate={s[4]}"
                        print(f"{tag}: error from float64 over the CPU "
                              f"float32 route's "
                              f"{ratio_text(got, *refs[s, which], outs)}",
                              flush=True)
                        if (s, which) not in first:
                            first[s, which] = (d.name,
                                               [t.clone() for t in got])
                        else:
                            same = all(map(torch.equal, got,
                                           first[s, which][1]))
                            print(f"{tag} bit-equal to "
                                  f"{first[s, which][0]}: {same}",
                                  flush=True)
    for (name, which, s), ts in times.items():
        print(f"AB {name:12s} fused_mlp_{which:8s} R={s[0]:5d} d={s[1]} "
              f"F={s[2]} rate={s[4]}: " + " ".join(f"{t:.4f}" for t in ts))
    return 0


def pre_exact(dev) -> int:
    """At rate 0 with g one-hot on 8 rows, dW2[:, o] is row sel[o]'s
    relu(pre), which the dyadic inputs make exact: it must equal the
    float64 value bit for bit. Returns the number of mismatches."""
    x, w1, b1, w2, _, _ = cs.mlp_inputs(5, 10007, 8, 2048, 8, dev)
    sel = [0, 1, 1000, 4097, 5000, 9000, 10005, 10006]
    g = torch.zeros((10007, 8), device=dev)
    for o, r in enumerate(sel):
        g[r, o] = 1.0
    with torch.no_grad():
        dw2 = fm_mod.fused_mlp_bwd(x, w1, b1, w2, g, 0.0, 7)[3]
    want = torch.relu(x[sel].double() @ w1.double() + b1.double()).float()
    return int((dw2.T != want).sum())


def check_mlp(dirs, dev) -> int:
    bad = 0
    for d in dirs:
        build_facts(d, ("fused_mlp",))
        if "keep_scale" in (d / "fused_mlp.cu").read_text():
            hash_sass(d)
        use(d)
        for r, din, f, dout, rate in MLP_EDGES:
            x, w1, b1, w2, b2, g = cs.mlp_inputs(r + f + din, r, din, f,
                                                 dout, dev, g_scale=0.05)
            with torch.no_grad():
                calls = (("fwd", lambda: [mlp_fwd(x, w1, b1, w2, b2, rate,
                                                  7)],
                          lambda: [fm_mod.fused_mlp_plain(x, w1, b1, w2, b2,
                                                          rate, 7)]),
                         ("bwd", lambda: fm_mod.fused_mlp_bwd(x, w1, b1, w2,
                                                              g, rate, 7),
                          lambda: fm_mod.fused_mlp_bwd_plain(x, w1, b1, w2,
                                                             g, rate, 7)))
                for which, fn, plain in calls:
                    got, again, want = fn(), fn(), plain()
                    torch.cuda.synchronize()
                    same = all(map(torch.equal, got, again))
                    bad += not same
                    text, n_bad = misses(got, want)
                    bad += n_bad
                    print(f"fused_mlp_{which} {d.name} R={r} d_in={din} "
                          f"F={f} d_out={dout} rate={rate}: bit-identical "
                          f"{same}; " + "; ".join(text), flush=True)
        if hasattr(build.load("fused_mlp"), "feta_fused_mlp_fwd_slabs"):
            keep_f, keep_b = cs.mlp_masks(dev, 1234, 0.1, rows=64)
            want = fm_mod.dropout_keep(1234, 64, 64, 0.1, dev)
            masks = torch.equal(keep_f, want) and torch.equal(keep_b, want)
            bad += not masks
            wrong = pre_exact(dev)
            bad += wrong != 0
            print(f"fused_mlp {d.name}: forward and backward masks "
                  f"bit-equal to dropout_keep {masks}; relu(pre) of 8 rows "
                  f"x 2048 units exact: {wrong} mismatches", flush=True)
    print(f"check mlp: {bad} failures")
    return 1 if bad else 0


# ---------------------------------------------------------- modulation

# (B, N, padding) of the A/B at H=8: the ZINC batch, B=32 N=128, the `r4`
# request and step at N=2048, the SBM batch at N=1024
MOD_AB = ((128, 48, 11), (32, 128, 17), (2, 2048, 60), (1, 2048, 100),
          (4, 1024, 60))
MOD_F64 = ((128, 48, 11), (1, 2048, 100))
# `--modulation --check`: (B, H, N, padding, pe given, deg given, the last
# graph's nodes all masked, scores at a 4-byte offset)
MOD_EDGES = ((3, 8, 1, 0, True, True, True, False),
             (2, 3, 4, 1, True, False, False, False),
             (3, 1, 17, 2, True, True, True, False),
             (128, 8, 48, 11, True, True, False, False),
             (2, 12, 48, 5, False, False, True, True),
             (2, 8, 128, 17, False, True, False, False),
             (3, 3, 129, 7, True, True, True, False),
             (2, 12, 300, 9, True, False, False, False),
             (2, 8, 1990, 9, True, True, True, False),
             (1, 8, 2048, 100, True, True, False, False),
             (2, 3, 2048, 60, False, False, True, True),
             (1, 1, 8200, 50, True, True, False, False))


def mod_case(seed, b, h, n, pad, dev, pe=True, deg=True, dead=False,
             offset=False):
    """`chip_smoke.modulation_inputs` (graph i loses its last pad + i mod 8
    nodes, pe 0 on graph 0's first 4 query rows) with pe or degree absent,
    the last graph all masked, or the scores 4 bytes past an aligned
    address: [scores, pe, deg, mask, g]."""
    scores, pe_, deg_, mask, g = cs.modulation_inputs(seed, b, h, n, pad,
                                                      dev)
    if dead:
        mask[-1] = 0.0
        pe_[-1] = 0.0
        deg_[-1] = 0.0
    if offset:
        buf = torch.empty(scores.numel() + 1, device=dev)
        buf[1:] = scores.reshape(-1)
        scores = buf[1:].view(scores.shape)
    return [scores, pe_ if pe else None, deg_ if deg else None, mask, g]


def mod_call(name, args, plain=False):
    fn = getattr(mod_mod, f"modulation_{name}" + ("_plain" if plain else ""))
    return fn(*args[:4]) if name == "fwd" else fn(*args)


def ab_modulation(dirs, dev, checks=True) -> int:
    inputs = {s: mod_case(sum(s), *s[:1], 8, *s[1:], dev) for s in MOD_AB}
    times, first = {}, {}
    for rnd, order in enumerate((dirs, dirs[::-1])):
        for d in order:
            use(d)
            for s in MOD_AB:
                args = inputs[s]
                for name in ("fwd", "bwd"):
                    fn = lambda: mod_call(name, args)
                    with torch.inference_mode():
                        times.setdefault((d.name, name, s), []).append(
                            (time_ms(fn), time_ms(fn, cold=True)))
                        if rnd or not checks:
                            continue
                        got = fn()
                        torch.testing.assert_close(
                            got, mod_call(name, args, True), **cs.KERNEL_TOL)
                        text = ""
                        if s in MOD_F64:
                            ratio = cs.cpu32_ratios(
                                [got], lambda a: [mod_call(name, a, True)],
                                (name,), args, f"{d.name} {name}")
                            text = (f" error from float64 over the CPU "
                                    f"float32 route's {ratio};")
                        key = (name, s)
                        if key not in first:
                            first[key] = (d.name, got.clone())
                            same = "first tree"
                        else:
                            same = (f"bit-equal to {first[key][0]}: "
                                    f"{torch.equal(got, first[key][1])}")
                        print(f"{d.name} modulation_{name} B={s[0]} N={s[1]}:"
                              f"{text} {same}", flush=True)
    for (tree, name, s), ts in times.items():
        b_ms, by = cs.bound(*cs.modulation_cost(inputs[s][3], 8, name))
        print(f"AB {tree:12s} modulation_{name} B={s[0]:3d} N={s[1]:4d}: "
              "warm " + " ".join(f"{w:.4f}" for w, _ in ts) + " cold "
              + " ".join(f"{c:.4f}" for _, c in ts)
              + f"; bound {b_ms:.4f} ms {by} ("
              + " ".join(f"{100 * b_ms / c:.1f}" for _, c in ts)
              + " % of cold)", flush=True)
    return 0


def check_modulation(dirs, dev) -> int:
    bad = 0
    for d in dirs:
        build_facts(d, ("modulation",))
        use(d)
        for e in MOD_EDGES:
            b, h, n, pad, pe, deg, dead, offset = e
            args = mod_case(b + h + n, b, h, n, pad, dev, pe, deg, dead,
                            offset)
            zero = cs.masked_cells(args[3]).expand_as(args[0])
            msg = []
            with torch.inference_mode():
                for name in ("fwd", "bwd"):
                    got, again = mod_call(name, args), mod_call(name, args)
                    want = mod_call(name, args, True)
                    torch.cuda.synchronize()
                    same = torch.equal(got, again)
                    zeros = bool((got[zero] == 0).all())
                    bad += (not same) + (not zeros)
                    m_text, n_bad = misses([got], [want])
                    bad += n_bad
                    msg.append(f"{name}: bit-identical {same}; 0 at masked "
                               f"cells {zeros}; " + "; ".join(m_text))
            print(f"modulation {d.name} B={b} H={h} N={n} pad~{pad} pe={pe} "
                  f"deg={deg} dead graph={dead} offset={offset} (team T, V = "
                  f"{mod_mod.team_geometry(n)}): "
                  + "; ".join(msg), flush=True)
    print(f"check modulation: {bad} failures")
    return 1 if bad else 0


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    if argv[0] == "--fused":
        mode = argv[1] if argv[1] in ("--check", "--times") else None
        dirs = [Path(a) for a in argv[1 + bool(mode):]]
        build_all(dirs, FUSED_LIBS)
        if mode == "--check":
            return max(check_fused(d, dev) for d in dirs)
        if mode == "--times":
            return times_fused(dirs, dev)
        return ab_fused(dirs, dev)
    if argv[0] == "--modulation":
        mode = argv[1] if argv[1] in ("--check", "--times") else None
        dirs = [Path(a) for a in argv[1 + bool(mode):]]
        build_all(dirs, ("modulation",))
        if mode == "--check":
            return check_modulation(dirs, dev)
        for d in dirs:
            build_facts(d, ("modulation",))
        return ab_modulation(dirs, dev, checks=mode is None)
    if argv[0] in ("--colstat", "--mlp"):
        mode = argv[1] if argv[1] in ("--check", "--times") else None
        dirs = [Path(a) for a in argv[1 + bool(mode):]]
        colstat = argv[0] == "--colstat"
        build_all(dirs, ("colstat",) if colstat else ("fused_mlp",))
        if mode == "--check":
            return (check_colstat if colstat else check_mlp)(dirs, dev)
        for d in dirs:
            build_facts(d, ("colstat",) if colstat else ("fused_mlp",))
        return (ab_colstat if colstat else ab_mlp)(dirs, dev,
                                                   checks=mode is None)
    if argv[0] == "--precision":
        build.CSRC = Path(argv[1])
        sys.argv = ["chip_smoke.py", "--precision"]
        return cs.main()
    if argv[0] == "--check":
        dirs = [Path(a) for a in argv[1:]]
        build_all(dirs, LIBS + FUSED_LIBS)
        if len(dirs) == 1:
            flash = check(dirs[0], dev)
        else:
            ref_m = reference_m(dirs[0], dev)
            flash = max([check(d, dev, ref_m) for d in dirs[1:]])
        return max(flash, *(check_fused(d, dev) for d in dirs))
    if argv[0] == "--dck":
        dirs = [Path(a) for a in argv[2:]]
        build_all(dirs)
        return dck(int(argv[1]), dirs, dev)
    dirs = [Path(a) for a in argv]
    build_all(dirs)
    return ab(dirs, dev)


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
