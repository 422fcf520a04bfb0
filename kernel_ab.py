"""A/B of the attention kernels across kernel source trees, on one card.

  python3 kernel_ab.py DIR [DIR ...]           time the forwards and passes
  python3 kernel_ab.py --check DIR [DIR ...]   build facts and edge checks
  python3 kernel_ab.py --dck DV DIR [DIR ...]  the key passes' errors
  python3 kernel_ab.py --precision DIR         chip_smoke.py --precision
  python3 kernel_ab.py --fused [--check] DIR [DIR ...]
                                               the same for the fused pair
  python3 kernel_ab.py --fused --times DIR [DIR ...]
                                               its times alone, and bits

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
tiles' edge shapes (where it misses, the indices of the misses), two runs
bit-identical, the folded forward and query pass bit-equal to the unfolded
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
        if ref_m is not None and "fwd" in name:
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
