"""Build the repository's host C++ sources under `native/` and bind them
with ctypes.

`native/<name>.cpp` is compiled on first use into
`build/lib<name>-<hash>.so` at the repository root, beside the CUDA
kernels (`build.py`; the hash covers the source and the flags), with the
flags of `native/Makefile`:

  c++ -O3 -fPIC -shared -std=c++17

The compiler is $CXX, else `c++` or `g++` on the PATH. A library that
fails to build raises: nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from feta_tmlr_tpu_torch.ops.kernels.build import BUILD_DIR

NATIVE = Path(__file__).resolve().parents[3] / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no C++ compiler ($CXX, c++, g++); the host "
                       "libraries under native/ cannot build")


def lib_path(name: str) -> Path:
    text = (NATIVE / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(text + " ".join(CXX_FLAGS).encode()
                            ).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile `native/<name>.cpp` unless its library is there; returns
    the library's path."""
    out = lib_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(NATIVE / f"{name}.cpp")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The bound library of `native/<name>.cpp`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib
