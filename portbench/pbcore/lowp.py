"""Roundings of a product's operands to a lower precision, for the control
that `correct` must fail: TF32 (10 explicit mantissa bits, to nearest, as
the tensor cores take fp32 operands with TF32 allowed) below float32, and
float8 e4m3 with one scale a tensor (amax to 448) below bfloat16."""
from __future__ import annotations

import torch


def tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def fp8(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    scale = 448.0 / torch.clamp(t.abs().amax(), min=1e-30)
    return (t * scale).to(torch.float8_e4m3fn).float() / scale


ROUNDINGS = {"float32": tf32, "bfloat16": fp8}
