"""The mixed-precision compute policy, as the JAX package's `config.py`.

FETA_COMPUTE_DTYPE=bfloat16 (or bf16) runs the GraphiT-FeTA models' hot
products in bf16: the attention's score and value products, the output
projection, the FFN and the Chebyshev filter, each with float32 sums
rounded once to bf16; parameters, gradients, the optimizer, the residual
stream, the softmax, the norms and the coefficient head stay float32.
Any other value (or none) is float32. A model reads the variable each
time it runs, so one model serves under either.

FETA_BF16_MODULATION (default "1") sends the pe and degree streams to the
attention kernels in bf16 as well under that policy; "0" keeps them
float32.

The JAX package's Pallas gates (FETA_PALLAS, its auto threshold) have no
counterpart here: a layer's `attention_impl` picks the kernel route.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def default_compute_dtype() -> torch.dtype:
    """bf16 where FETA_COMPUTE_DTYPE is "bfloat16" or "bf16", else
    float32."""
    name = os.environ.get("FETA_COMPUTE_DTYPE", "float32")
    return {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16}.get(
        name, torch.float32)


def modulation_dtype(cdt: torch.dtype) -> Optional[torch.dtype]:
    """The pe and degree streams' dtype under the compute dtype `cdt`: bf16
    where `cdt` is bf16 and FETA_BF16_MODULATION is "1" (the default),
    else None (float32)."""
    if cdt == torch.bfloat16 and os.environ.get(
            "FETA_BF16_MODULATION", "1") == "1":
        return cdt
    return None


def refuse_bf16(what: str, item: str) -> None:
    """Raise NotImplementedError where the compute dtype is bf16 for a
    part of the port that has no bf16 path yet: it never runs in float32
    quietly under the policy."""
    if default_compute_dtype() == torch.bfloat16:
        raise NotImplementedError(
            f"{what} has no bf16 compute path in the port yet "
            f"(FETA_COMPUTE_DTYPE={os.environ.get('FETA_COMPUTE_DTYPE')}; "
            f"ROADMAP {item}); unset FETA_COMPUTE_DTYPE to run it in "
            f"float32")
