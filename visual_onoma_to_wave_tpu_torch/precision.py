"""fp32 precision pin for parity with the JAX reference.

On the card, cuDNN convolutions default to TF32 (about three decimal digits),
which breaks fp32 parity with the reference the same way the TPU's default
matmul precision would. `pin_fp32` turns TF32 off for both matmuls and cuDNN
convolutions; `precision_flags` reports the two flags.
"""
from __future__ import annotations

import torch


def pin_fp32() -> dict[str, bool]:
    """Disable TF32 for CUDA matmuls and cuDNN convolutions; return the flags."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return precision_flags()


def precision_flags() -> dict[str, bool]:
    return {
        "cuda.matmul.allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "cudnn.allow_tf32": bool(torch.backends.cudnn.allow_tf32),
    }
