"""A/B of the backward passes across kernel source trees, on one card.

  python3 kernel_ab.py DIR [DIR ...]           time the four passes
  python3 kernel_ab.py --check DIR             build facts and edge checks
  python3 kernel_ab.py --dck DV DIR [DIR ...]  the key passes' errors
  python3 kernel_ab.py --precision DIR         chip_smoke.py --precision

Each DIR holds a copy of `feta_tmlr_tpu_torch/csrc` (a variant, edited or
taken from another commit). The default mode builds every variant's
`flash_bwd` and `flash_hf` libraries side by side (their file names carry
the source hash, so variants do not overwrite each other), then times the
query passes `flash_bwd_q` and `flash_bwd_q_hf` and the key passes
`flash_bwd_k` and `flash_bwd_k_hf` at the training paths' shapes with
chip_smoke's `time_ms` (device ms, median of 25 calls) in two rounds, the
second in reverse order. Each variant is held to its pass's plain version
within chip_smoke's KERNEL_TOL and compared bit for bit with the first
variant. It prints the card's name and power limit, then one line per
variant and shape: `AB <variant> <kernel> B= N= dv=: <ms round 1> <ms
round 2>`. Compare variants only within one run.

`--check` prints each kernel's registers and spills (`nvcc -Xptxas -v`)
and its count of `HMMA.1688.F32.TF32` (`cuobjdump -sass` of a cubin),
then holds each backward pass to its plain version at the tiles' edge
shapes (where it misses, the indices of the misses), two runs
bit-identical, the folded query pass bit-equal to the unfolded one, and
times the passes at N >= 1024 (median of 10). `--dck` prints each key
pass's max abs error of dvw, dck and dx over max |float64| against the CPU
float32 route's on the same inputs, over 6 seeds at B=1, H=8, N=2048,
D=64 and value width DV, with the max and mean of the ratios. `--precision`
runs chip_smoke's precision probe on DIR's kernels.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from chip_smoke import bwd_inputs, build, fl_mod, time_ms

# (kernel, B, N, padding, dv): each unfolded pass at the SBM N=1024 batch
# and the ZINC batch, each folded pass at the N=2048 training shape
SHAPES = tuple((f"flash_bwd_{p}", *shape) for p in ("q", "k") for shape in (
    (4, 1024, 60, 64), (4, 1024, 60, 8), (128, 48, 11, 64),
    (128, 48, 11, 8))) + tuple(
        (f"flash_bwd_{p}_hf", 1, 2048, 100, dv) for p in ("q", "k")
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
LIBS = ("flash_bwd", "flash_hf")


def use(src: Path) -> None:
    """Point the kernel build and the wrappers at one variant's sources."""
    build.CSRC = src
    build._libs.clear()
    fl_mod._fns.clear()


def build_all(dirs) -> None:
    """One nvcc per distinct library of the variants, all started
    together."""
    started, seen = [], set()
    for d in dirs:
        use(d)
        for name in LIBS:
            path = build._lib_path(name)
            started.append((name, None if path in seen else
                            build._start(name)))
            seen.add(path)
    for name, job in started:
        build._finish(name, job)


def plain_of(name):
    return (fl_mod.flash_bwd_q_plain if "_q" in name
            else fl_mod.flash_bwd_k_plain)


def ab(dirs, dev) -> int:
    inputs = {s: bwd_inputs(s[1] + s[2] + s[4] + 1, s[1], 8, s[2], 64, s[4],
                            s[3], dev)[0] for s in SHAPES}
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


def build_facts(src: Path) -> None:
    """Registers and spills per kernel, and its HMMA.1688.F32.TF32
    count, for both libraries of `src`."""
    out_dir = build.BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = Path(build._nvcc())
    for name in LIBS:
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


def check(src: Path, dev) -> int:
    build_facts(src)
    use(src)
    bad = 0
    for name, b, h, n, pad, d, dv in EDGES:
        args, _, _ = bwd_inputs(b + n + dv + 1, b, h, n, d, dv, pad, dev,
                                guard_rows=min(n, 8))
        fn = getattr(fl_mod, name)
        with torch.inference_mode():
            got, again = fn(*args), fn(*args)
            want = plain_of(name)(*args)
            twin = fl_mod.flash_bwd_q(*args) if name.endswith("q_hf") else ()
            torch.cuda.synchronize()
        msg = [f"bit-identical {all(map(torch.equal, got, again))}"]
        bad += not all(map(torch.equal, got, again))
        if twin:
            equal = all(map(torch.equal, got, twin))
            msg.append(f"bit-equal to the unfolded pass {equal}")
            bad += not equal
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
        t = time_ms(lambda: fn(*args), reps=10) if n >= 1024 else None
        print(f"{name} B={b} H={h} N={n} D={d} dv={dv}: " + "; ".join(msg)
              + (f"; {t:.4f} ms" if t is not None else ""), flush=True)
    print(f"check: {bad} failures")
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
    if argv[0] == "--precision":
        build.CSRC = Path(argv[1])
        sys.argv = ["chip_smoke.py", "--precision"]
        return cs.main()
    if argv[0] == "--check":
        build_all([Path(argv[1])])
        return check(Path(argv[1]), dev)
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
