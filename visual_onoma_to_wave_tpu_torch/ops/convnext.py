"""ConvNeXt block and trunk of the Vocos vocoder: CUDA kernels + plain PyTorch versions.

Replaces the TPU kernels `visual_onoma_to_wave_tpu/ops/pallas_convnext.py::
convnext_block` and `::convnext_trunk`. One block, on x (B, T, C)
feature-last (the math of `pallas_convnext.py::_block_math`):

    h = depthwise k-tap conv of x (zero padding per item, fp32 sum) + db
    h = LayerNorm(h) * ls + lb           (fp32 statistics, eps 1e-6)
    a = GELU(h @ w1 + b1)                (tanh form by default, erf if asked)
    y = x + gamma * (a @ w2 + b2)

Operands (x, dw, w1, w2) are fp32 or bf16 and every product accumulates in
fp32; for bf16, h, a and y are rounded to bf16 where the TPU kernel rounds
them. The trunk is `L` blocks in sequence with stacked (L, ...) weights.

`convnext_block` and `convnext_trunk` launch the CUDA kernels
(`csrc/convnext.cu`, built at first use by `ops/cuda_build.py`) for tensors
on the card and take `convnext_block_reference` / `convnext_trunk_reference`
for tensors on the CPU. They never fall back: a CUDA tensor the kernels do
not take (C other than 128, 256 or 512; M not a multiple of 128; even K), a
failed build, a refused launch or a call that would need a gradient
raises. Any T is taken: the TPU kernels'
T % 16, C % 128 and M % 128 are tiling rules of the TPU, not of the math.
Each wrapper counts its kernel launches in `.launches`.

What bounds the kernels on the card, and why the trunk is a cooperative
persistent kernel, is written in `csrc/convnext.cu`.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from visual_onoma_to_wave_tpu_torch.ops.cuda_build import (
    check_inference,
    check_launch,
    load_library,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WIDTHS = (128, 256, 512)
_M_STEP = 128


def convnext_block_reference(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps: float = 1e-6,
                             gelu_approximate: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the block kernel. x: (B, T, C); dw (K, 1, C)
    or (K, C); w1 (C, M); w2 (M, C); the rest per channel. Returns x.dtype."""
    cdt = x.dtype
    B, T, C = x.shape
    K = dw.shape[0]
    dw = dw.reshape(K, C).to(cdt).float()
    half = (K - 1) // 2
    xp = F.pad(x.float(), (0, 0, half, half))
    acc = torch.zeros(B, T, C, dtype=torch.float32, device=x.device)
    for k in range(K):
        acc = acc + xp[:, k:k + T] * dw[k]
    h = acc + db.float()
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    h = (h * ls.float() + lb.float()).to(cdt)
    # bf16 operands: products of bf16 values are exact in fp32, so fp32
    # products of the rounded operands are bf16 products with fp32 sums
    a = h.float() @ w1.to(cdt).float() + b1.float()
    a = F.gelu(a, approximate="tanh" if gelu_approximate else "none").to(cdt)
    o = a.float() @ w2.to(cdt).float() + b2.float()
    return (x.float() + gamma.float() * o).to(cdt)


def convnext_trunk_reference(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps: float = 1e-6,
                             gelu_approximate: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the trunk kernel: `L` reference blocks in
    sequence, the weights stacked on a leading L axis."""
    for layer in zip(dw, db, ls, lb, w1, b1, w2, b2, gamma):
        x = convnext_block_reference(x, *layer, eps=eps, gelu_approximate=gelu_approximate)
    return x


def _checked(x: torch.Tensor, w1: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name} kernel takes float32/bfloat16; got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"{name} takes x as (B, T, C); got {tuple(x.shape)}")
    C, M = x.shape[-1], w1.shape[-1]
    if C not in _WIDTHS:
        raise ValueError(f"{name} kernel takes C in {_WIDTHS}; got {C}")
    if M % _M_STEP:
        raise ValueError(f"{name} kernel takes M a multiple of {_M_STEP}; got {M}")


def _operands(name: str, L: int, x, dw, db, ls, lb, w1, b1, w2, b2, gamma):
    """Check the weights against x and return the kernel operands, contiguous:
    dw (L, K, C), w1, w2 in x's dtype, the vectors in fp32, and K."""
    C, M = x.shape[-1], w1.shape[-1]
    K = dw.numel() // (L * C)
    sizes = {"dw": (dw, L * K * C), "db": (db, L * C), "ls": (ls, L * C), "lb": (lb, L * C),
             "w1": (w1, L * C * M), "b1": (b1, L * M), "w2": (w2, L * M * C),
             "b2": (b2, L * C), "gamma": (gamma, L * C)}
    for arg, (t, n) in sizes.items():
        if t.numel() != n or t.device != x.device:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} on {t.device} does not fit "
                             f"x {tuple(x.shape)} on {x.device} (L={L}, M={M})")
    if K % 2 == 0:
        raise ValueError(f"{name} kernel takes an odd kernel size; got {K}")
    ops = [t.to(x.dtype).contiguous() for t in (dw, w1, w2)]
    ops += [t.float().contiguous() for t in (db, ls, lb, b1, b2, gamma)]
    return ops, K


def _load_library() -> ctypes.CDLL:
    # block: 11 pointers, 7 ints (B, T, C, M, K, dtype, gelu_tanh), eps, stream;
    # trunk: + scratch pointer, + layers int
    tail = [ctypes.c_float, ctypes.c_void_p]
    return load_library("convnext", {
        "convnext_block_fwd": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + tail,
        "convnext_trunk_fwd": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + tail,
    })


def convnext_block(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps: float = 1e-6,
                   gelu_approximate: bool = True) -> torch.Tensor:
    """One ConvNeXt block. x: (B, T, C); dw (K, 1, C) or (K, C); w1 (C, M);
    w2 (M, C); db, ls, lb, b2, gamma (C,); b1 (M,). CPU tensors take
    `convnext_block_reference`; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return convnext_block_reference(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps,
                                        gelu_approximate)
    _checked(x, w1, "convnext_block")
    check_inference("convnext_block", x, dw, db, ls, lb, w1, b1, w2, b2, gamma)
    B, T, C = x.shape
    M = w1.shape[-1]
    (dw, w1, w2, db, ls, lb, b1, b2, gamma), K = _operands(
        "convnext_block", 1, x, dw, db, ls, lb, w1, b1, w2, b2, gamma)
    x = x.contiguous()
    y = torch.empty_like(x)
    lib = _load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.convnext_block_fwd(
            x.data_ptr(), y.data_ptr(), dw.data_ptr(), db.data_ptr(), ls.data_ptr(),
            lb.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            gamma.data_ptr(), B, T, C, M, K, _DTYPE_CODES[x.dtype], int(gelu_approximate),
            eps, stream)
    check_launch("convnext_block", err)
    convnext_block.launches += 1
    return y


convnext_block.launches = 0


def convnext_trunk(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps: float = 1e-6,
                   gelu_approximate: bool = True) -> torch.Tensor:
    """All L blocks in one launch. x: (B, T, C); weights stacked on a leading
    L axis: dw (L, K, 1, C) or (L, K, C); w1 (L, C, M); w2 (L, M, C); db, ls,
    lb, b2, gamma (L, C); b1 (L, M). Equals L `convnext_block` calls. CPU
    tensors take `convnext_trunk_reference`; CUDA tensors launch the kernel
    or raise."""
    if x.device.type == "cpu":
        return convnext_trunk_reference(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps,
                                        gelu_approximate)
    _checked(x, w1, "convnext_trunk")
    check_inference("convnext_trunk", x, dw, db, ls, lb, w1, b1, w2, b2, gamma)
    B, T, C = x.shape
    L, M = w1.shape[0], w1.shape[-1]
    (dw, w1, w2, db, ls, lb, b1, b2, gamma), K = _operands(
        "convnext_trunk", L, x, dw, db, ls, lb, w1, b1, w2, b2, gamma)
    x = x.contiguous()
    y = torch.empty_like(x)
    scratch = torch.empty_like(x)   # the activation ping-pongs between y and scratch
    lib = _load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.convnext_trunk_fwd(
            x.data_ptr(), y.data_ptr(), scratch.data_ptr(), dw.data_ptr(), db.data_ptr(),
            ls.data_ptr(), lb.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), gamma.data_ptr(), L, B, T, C, M, K, _DTYPE_CODES[x.dtype],
            int(gelu_approximate), eps, stream)
    check_launch("convnext_trunk", err)
    convnext_trunk.launches += 1
    return y


convnext_trunk.launches = 0
