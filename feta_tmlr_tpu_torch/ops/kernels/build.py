"""Build the CUDA sources under `csrc/` and bind them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (no PyTorch headers, so
nvcc takes seconds, not minutes) and is compiled on first use into
`build/lib<name>-<hash>.so` at the repository root (the hash covers the
source, the shared headers `csrc/*.cuh` and the flags), with

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
       -Xcompiler -fPIC

An edited kernel is therefore never served from a stale library.
`build_all()` starts one nvcc per source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("flash_fwd", "flash_bwd", "flash_hf", "colstat", "fused_mlp",
           "modulation", "fused_attention")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def _lib_path(name: str) -> Path:
    text = b"".join(p.read_bytes() for p in
                    [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every missing library, all nvcc processes in parallel."""
    names = list(names)
    started = {n: _start(n) for n in names}
    for n in names:
        _finish(n, started[n])


def load(name: str) -> ctypes.CDLL:
    """The bound library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib

