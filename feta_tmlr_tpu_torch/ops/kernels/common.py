"""Pieces shared by the attention kernels' wrappers and plain versions.

Operand layout of the kernels (all float32, contiguous):
  xa [B, H, N, D]   x [B, N, D]   cq, ck [B, H, N]   c0 [H]
  pe [B, N, N] or None   deg [B, N] or None   mask [B, N] (1 = real node)
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30
EPS = 1e-9


def plain_scores(xa, x, cq, ck, c0, mask, inv_sqrt):
    """Masked scaled scores [B, H, N, N]; -1e30 on padded keys."""
    s = (xa @ x[:, None].transpose(-1, -2) + cq[..., :, None]
         + ck[..., None, :] + c0[None, :, None, None]) * inv_sqrt
    return torch.where(mask[:, None, None, :] > 0, s,
                       torch.full_like(s, NEG_INF))


def plain_pd(pe, deg, ref):
    """Modulation pe[i, j] * deg[j] as [B, 1, N, N] (1 where absent)."""
    b, _, n, _ = ref.shape
    pd = torch.ones((b, 1, n, n), dtype=ref.dtype, device=ref.device)
    if pe is not None:
        pd = pd * pe[:, None]
    if deg is not None:
        pd = pd * deg[:, None, None, :]
    return pd


def cuda_or_plain(name, t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def check_f32(name, device, items, entry) -> None:
    """Raise unless every (key, tensor, shape) of `items` is a contiguous
    float32 tensor of that shape on `device` (the optional pe, deg and wq
    may be None), and unless none requires grad while grad mode is on: a
    raw kernel wrapper is not differentiable, `entry` is."""
    for key, t, shape in items:
        if t is None and key in ("pe", "deg", "wq"):
            continue
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"{name}: {key} must be float32 on {device}, "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for _, t, _ in items):
        raise RuntimeError(
            f"{name}: the raw kernel wrapper is not differentiable; call it "
            f"under torch.no_grad(), or use {entry} for gradients")


def check_operands(name, xa, x, cq, ck, c0, pe, deg, mask, extra=(),
                   entry="flash_graphit_attention(_heads) (FlashGraphiT)"
                   ) -> None:
    """Raise unless every operand is a contiguous float32 CUDA tensor of
    the layout above, on one device."""
    b, h, n, d = xa.shape
    shapes = {"xa": (xa, (b, h, n, d)), "x": (x, (b, n, d)),
              "cq": (cq, (b, h, n)), "ck": (ck, (b, h, n)),
              "c0": (c0, (h,)), "pe": (pe, (b, n, n)),
              "deg": (deg, (b, n)), "mask": (mask, (b, n))}
    check_f32(name, xa.device,
              [(k, t, s) for k, (t, s) in shapes.items()] + list(extra),
              entry)


def bwd_row_constants(g_heads, outh, se, su, mask):
    """Row constants of the backward, each [B, H, N], from the
    per-head cotangent g_heads and output outh [B, H, N, dv] and the
    forward's row sums se, su [B, H, N]:

      safe = |su/se| > 1e-9 ? su/se : 1     (guard: the same test)
      r    = safe * sum_d(g * outh)
      ise  = 1/se      qa = qmask/safe
      beta = guard * r / safe^2             c = (1 - guard) * r
    """
    delta = (g_heads * outh).sum(-1)
    denom = su / se
    guard = (denom.abs() > EPS).to(denom.dtype)
    safe = torch.where(guard > 0, denom, torch.ones_like(denom))
    r = safe * delta
    ise = 1.0 / se
    qa = mask[:, None, :] / safe
    beta = r / (safe * safe) * guard
    c = (1.0 - guard) * r
    return ise, qa, beta, c


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def bind(lib, fn_name: str, n_ptrs: int, n_ints: int, n_floats: int = 1):
    """Set ctypes signatures: n_ptrs void*, n_ints int, n_floats float,
    then the stream; returns int (cudaError_t)."""
    fn = getattr(lib, fn_name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                   + [ctypes.c_float] * n_floats + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.feta_cuda_error_string.argtypes = [ctypes.c_int]
    lib.feta_cuda_error_string.restype = ctypes.c_char_p
    return fn


def check_launch(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.feta_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")
