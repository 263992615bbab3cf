"""Precision: the fp32 pin for parity with the JAX reference, and the bf16
compute dtype of the JAX package's `dtype=` modules.

On the card, cuDNN convolutions default to TF32 (about three decimal digits),
which breaks fp32 parity with the reference the same way the TPU's default
matmul precision would. `pin_fp32` turns TF32 off for both matmuls and cuDNN
convolutions, and lets no bf16 matmul reduce in bf16 (cuBLAS's split-K
option: the reference's bf16 products sum in fp32); `precision_flags`
reports the three flags.

`leaky_relu` is leaky ReLU as flax computes it in a compute dtype.

`compute_dtype` reads a compute dtype the way the JAX package does
(`train.compute_dtype`, a vocoder's `dtype`): bfloat16 for "bfloat16" /
"bf16", float32 otherwise. `in_dtype` runs a linear or convolution
function, and `at_dtype` such a module, as a flax layer with `dtype=` runs it: parameters stay fp32, the weight and the
input are cast to the compute dtype, the product sums in fp32 and is rounded
once to the compute dtype, and the bias is added in the compute dtype. In
float32 it is the module's own forward, unchanged.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn


def pin_fp32() -> dict[str, bool]:
    """Disable TF32 for CUDA matmuls and cuDNN convolutions and bf16
    reductions in cuBLAS; return the flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return precision_flags()


def precision_flags() -> dict[str, bool]:
    return {
        "cuda.matmul.allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "cudnn.allow_tf32": bool(torch.backends.cudnn.allow_tf32),
        "cuda.matmul.allow_bf16_reduced_precision_reduction":
            bool(torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction),
    }


def compute_dtype(value) -> torch.dtype:
    """torch.bfloat16 for "bfloat16", "bf16" or torch.bfloat16; torch.float32
    for anything else (None, "float32", "fp32", ...), as the JAX package's
    `VTTS.from_config` reads `train.compute_dtype`."""
    if isinstance(value, torch.dtype):
        return torch.bfloat16 if value == torch.bfloat16 else torch.float32
    return torch.bfloat16 if str(value).lower() in ("bfloat16", "bf16") else torch.float32


def in_dtype(op, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
             dtype: torch.dtype, **kw) -> torch.Tensor:
    """`op(x, w, b, **kw)` (`F.linear`, `F.conv1d`, `F.conv2d`,
    `F.conv_transpose1d`) at compute dtype `dtype`: x and w cast to it, the
    product rounded once (fp32 sums), then the bias added in `dtype` (on
    the last axis for `F.linear`, on the channel axis for a convolution).
    In float32, `op(x, w, b, **kw)` unchanged."""
    if dtype == torch.float32:
        return op(x, w, b, **kw)
    y = op(x.to(dtype), w.to(dtype), None, **kw)
    if b is None:
        return y
    return y + b.to(dtype).reshape((-1,) if op is F.linear else (-1,) + (1,) * (y.ndim - 2))


@functools.lru_cache(maxsize=None)
def _slope_in(slope: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(slope, dtype=dtype))


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """`F.leaky_relu(x, slope)` with the slope rounded to x's dtype, as
    flax's `nn.leaky_relu` multiplies a bf16 x by its weakly typed slope in
    bf16 (0.1 becomes 0.10009765625). In float32 it is `F.leaky_relu(x,
    slope)` bit for bit."""
    return F.leaky_relu(x, _slope_in(slope, x.dtype))


def at_dtype(m: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`m(x)` for an `nn.Linear`, `nn.Conv1d`, `nn.Conv2d` or
    `nn.ConvTranspose1d` at compute dtype `dtype` (`in_dtype`); in float32
    what the module's own forward computes."""
    if isinstance(m, nn.Linear):
        return in_dtype(F.linear, x, m.weight, m.bias, dtype)
    if isinstance(m, nn.ConvTranspose1d):
        return in_dtype(F.conv_transpose1d, x, m.weight, m.bias, dtype, stride=m.stride,
                        padding=m.padding, output_padding=m.output_padding, groups=m.groups,
                        dilation=m.dilation)
    return in_dtype(lambda xd, w, b: m._conv_forward(xd, w, b), x, m.weight, m.bias, dtype)
