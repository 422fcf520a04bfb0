"""A/B of the backward key passes across kernel source trees, on one card.

  python3 kernel_ab.py DIR [DIR ...]

Each DIR holds a copy of `feta_tmlr_tpu_torch/csrc` (a variant, edited or
taken from another commit). The script builds every variant's `flash_bwd`
and `flash_hf` libraries side by side (their file names carry the source
hash, so variants do not overwrite each other), then times `flash_bwd_k`
and `flash_bwd_k_hf` at the training paths' shapes with chip_smoke's
`time_ms` (device ms, median of 25 calls) in two rounds, the second in
reverse order. Each variant is held to the plain version within
chip_smoke's KERNEL_TOL and compared bit for bit with the first variant.
It prints the card's name and power limit, then one line per variant and
shape: `AB <variant> <kernel> B= N= dv=: <ms round 1> <ms round 2>`.
Compare variants only within one run.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

import chip_smoke as cs
from chip_smoke import bwd_inputs, build, fl_mod, time_ms

# (kernel, B, N, padding, dv): the unfolded pass at the SBM N=1024 batch
# and the ZINC batch, the folded pass at the N=2048 training shape
SHAPES = (("flash_bwd_k", 4, 1024, 60, 64), ("flash_bwd_k", 4, 1024, 60, 8),
          ("flash_bwd_k", 128, 48, 11, 64), ("flash_bwd_k", 128, 48, 11, 8),
          ("flash_bwd_k_hf", 1, 2048, 100, 64),
          ("flash_bwd_k_hf", 1, 2048, 100, 8))
LIBS = ("flash_bwd", "flash_hf")


def use(src: Path) -> None:
    """Point the kernel build and the wrappers at one variant's sources."""
    build.CSRC = src
    build._libs.clear()
    fl_mod._fns.clear()


def main(dirs) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    started, seen = [], set()
    for d in dirs:   # one nvcc per distinct library, all started together
        use(d)
        for name in LIBS:
            path = build._lib_path(name)
            started.append((name, None if path in seen else
                            build._start(name)))
            seen.add(path)
    for name, job in started:
        build._finish(name, job)
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
                    want = fl_mod.flash_bwd_k_plain(*inputs[s])
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


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    sys.exit(main([Path(a) for a in sys.argv[1:]]))
