"""Pieces shared by the attention kernels' wrappers and plain versions.

Operand layout of the kernels (contiguous):
  xa [B, H, N, D]   x [B, N, D]   cq, ck [B, H, N]   c0 [H]
  pe [B, N, N] or None   deg [B, N] or None   mask [B, N] (1 = real node)

All float32, except under the bf16 compute policy (`config.py`), which the
unfolded flash kernels, colstat and the fused pair take: there the values
(xa, x, and vw and g where a kernel has them) are bf16, and pe and deg
bf16 as well or float32 (FETA_BF16_MODULATION 1 or 0; the fused pair takes
them float32 only, as the JAX wrapper casts them); the masks, cq, ck, c0
and the row statistics stay float32 (`operand_dtypes`). The fused MLP
(`fused_mlp.py`) takes bf16 values with float32 biases. Every other kernel
takes float32 only and raises on a bf16 operand.
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


def upcast(t):
    """A bf16 tensor as float32 (exactly); any other tensor, or None, as it
    is: the plain versions compute from bf16 operands in float32, as the
    JAX kernels' dots take bf16 operands into f32 accumulators."""
    return t.float() if t is not None and t.dtype == torch.bfloat16 else t


def rounded(t, dtype):
    """t rounded to bf16 (and kept in its own dtype) where `dtype` is bf16,
    else t: where the JAX kernels cast P, ds or attn to their operands'
    dtype before a product."""
    return t.to(dtype).to(t.dtype) if dtype == torch.bfloat16 else t


def cuda_or_plain(name, t) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device.type == "cuda"


def check_f32(name, device, items, entry, dtypes=None) -> None:
    """Raise unless every (key, tensor, shape) of `items` is a contiguous
    tensor of that shape on `device`, float32 or the dtype that `dtypes`
    gives its key (the optional pe, deg and wq may be None), and unless
    none requires grad while grad mode is on: a raw kernel wrapper is not
    differentiable, `entry` is."""
    for key, t, shape in items:
        if t is None and key in ("pe", "deg", "wq"):
            continue
        want = (dtypes or {}).get(key, torch.float32)
        if t.device != device or t.dtype != want:
            hint = ("; this kernel takes float32 operands only (bf16 "
                    "operands: ROADMAP Queue 2 item A2)"
                    if dtypes is None and t.dtype == torch.bfloat16 else "")
            raise ValueError(f"{name}: {key} must be "
                             f"{str(want).replace('torch.', '')} on {device}, "
                             f"got {t.dtype} on {t.device}{hint}")
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


VALUES = ("xa", "x", "vw", "g")   # bf16 under the bf16 compute policy
MODULATION = ("pe", "deg")        # bf16 too, unless FETA_BF16_MODULATION=0


def operand_dtypes(xa, pe, deg):
    """(values dtype, modulation dtype) of a bf16-capable kernel's
    operands, read off xa and pe (else deg): (float32, float32), (bf16,
    bf16) or (bf16, float32). Every operand must then have its key's
    dtype (`check_operands`), so any other combination raises."""
    f32, bf16 = torch.float32, torch.bfloat16
    vdt = bf16 if xa.dtype == bf16 else f32
    mod = pe if pe is not None else deg
    mdt = bf16 if vdt == bf16 and (mod is None or mod.dtype == bf16) else f32
    return vdt, mdt


def check_operands(name, xa, x, cq, ck, c0, pe, deg, mask, extra=(),
                   entry="flash_graphit_attention(_heads) (FlashGraphiT)",
                   bf16=False, f32_modulation=False):
    """Raise unless every operand is a contiguous CUDA tensor of the layout
    above, on one device, all float32; with `bf16` (a kernel that has bf16
    instantiations) the operands may instead follow the bf16 compute
    policy (`operand_dtypes`), with `f32_modulation` (the fused pair) with
    pe and deg float32 whatever the values are. Returns (values dtype,
    modulation dtype)."""
    b, h, n, d = xa.shape
    shapes = {"xa": (xa, (b, h, n, d)), "x": (x, (b, n, d)),
              "cq": (cq, (b, h, n)), "ck": (ck, (b, h, n)),
              "c0": (c0, (h,)), "pe": (pe, (b, n, n)),
              "deg": (deg, (b, n)), "mask": (mask, (b, n))}
    vdt, mdt = (operand_dtypes(xa, pe, deg) if bf16
                else (torch.float32, torch.float32))
    if f32_modulation:
        mdt = torch.float32
    dtypes = None
    if bf16:
        dtypes = {**dict.fromkeys(VALUES, vdt),
                  **dict.fromkeys(MODULATION, mdt)}
    check_f32(name, xa.device,
              [(k, t, s) for k, (t, s) in shapes.items()] + list(extra),
              entry, dtypes)
    return vdt, mdt


def dtype_suffix(vdt, mdt) -> str:
    """The C entry point's suffix of a bf16-capable kernel for these
    operand dtypes: "" (float32), "_bf16" (bf16 values and modulation) or
    "_bf16_f32pe" (bf16 values, float32 pe and deg)."""
    if vdt != torch.bfloat16:
        return ""
    return "_bf16" if mdt == torch.bfloat16 else "_bf16_f32pe"


def bwd_row_constants(g_heads, outh, se, su, mask):
    """Row constants of the backward, each [B, H, N], from the
    per-head cotangent g_heads and output outh [B, H, N, dv] and the
    forward's row sums se, su [B, H, N]:

      safe = |su/se| > 1e-9 ? su/se : 1     (guard: the same test)
      r    = safe * sum_d(g * outh)
      ise  = 1/se      qa = qmask/safe
      beta = guard * r / safe^2             c = (1 - guard) * r
    """
    delta = (upcast(g_heads) * upcast(outh)).sum(-1)
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
