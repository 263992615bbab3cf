"""Key-masked multi-head attention core: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel `visual_onoma_to_wave_tpu/ops/pallas_attention.py::
flash_mha`. Per batch item and head:

    logits = Q K^T / sqrt(dk)              (fp32)
    logits[key is padding] = -inf
    attn = softmax(logits); fully-masked query rows -> exactly 0
    ctx = attn V                           (attn re-cast to the input dtype)

In bf16 both the plain version and the CUDA kernel round the normalised
attn, as the TPU kernel does: the kernel takes two passes over the keys,
the first for each row's max and sum, the second for P = bf16(exp(s - m) *
(1/sum)) and P V, and rounds the fp32 context once (see `csrc/flash_mha.cu`).

Q, K, V and ctx are (B, T, H*dk) with heads packed on the feature axis -- the
raw projection outputs -- and key_pad_mask is (B, T), True = padding.

`attention_core` calls the custom op `votw::attention_core`
(`torch.library`, registered when this module is imported): its CUDA
implementation launches the kernel (`csrc/flash_mha.cu`), its CPU
implementation is `attention_core_reference`, and its fake implementation
states the output's shape, so `torch.export` records the op by name and an
exported program launches the kernel on the card. The op never falls back:
a CUDA tensor the kernel does not take, a failed build, a refused launch, a
call that would need a gradient or any other device raises. A CPU call that
needs a gradient takes `attention_core_reference` directly (the op has no
backward). `attention_core.launches` counts kernel launches.

What bounds the kernel on the card: one (T, T) score tile per (item, head)
costs 4*T*Tk*dk FLOPs over the Tk valid keys -- 0.5 GFLOP at the serving
decoder's T = Tk = 1000, dk = 128 -- while the unique bytes are Q, K, V and
ctx, 4*T*dk*4 = 2 MB: ~256 FLOP per byte, so fp32 is bound by arithmetic,
not by device memory. The plain version instead writes the (B, H, T, T)
fp32 logits to device memory (128 MB at B = 16, H = 2, T = 1000) and
re-reads them through mask, softmax and the product with V; the kernel
keeps every score on chip (online softmax over 64-key tiles, skipping the
tiles whose keys are all padding; bf16 in two passes) and runs both
products on the tensor cores (`wgmma`; fp32 as 3xTF32: each operand split
into a TF32 high part and its fp32 remainder, three products hi*lo + lo*hi +
hi*hi, fp32 sums).
See PERF.md for its time on the card beside the plain version's and SDPA's.

The kernel is built at first use by `ops/cuda_build.py` (nvcc for sm_90a
into `build/kernels/<hash>/`, loaded with ctypes: a plain C entry point, no
PyTorch headers).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from visual_onoma_to_wave_tpu_torch.ops.cuda_build import (
    check_inference,
    check_launch,
    load_library,
)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def attention_core_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             key_pad_mask: torch.Tensor | None,
                             n_head: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the JAX module's non-fused core
    (JAX models/layers.py:97-114). The logits Q K^T / sqrt(dk) are fp32 sums
    of the bf16 (or fp32) operands' exact products, masked and softmaxed in
    fp32; in bf16 the normalised probabilities P are rounded to bf16 before
    the product with V (JAX's `attn.astype(dtype)`), that product sums in
    fp32 and the output is rounded to bf16 once (JAX's bf16 einsum)."""
    B, T, HD = q.shape
    dk = HD // n_head
    qh, kh, vh = (x.reshape(B, T, n_head, dk).float() for x in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (1.0 / dk ** 0.5)
    if key_pad_mask is not None:
        logits = logits.masked_fill(key_pad_mask[:, None, None, :], -torch.inf)
    attn = torch.nan_to_num(torch.softmax(logits, dim=-1)).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), vh)
    return out.reshape(B, T, HD).to(q.dtype)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_pad_mask: torch.Tensor | None,
                   n_head: int) -> torch.Tensor:
    """Masked softmax attention on packed (B, T, H*dk) heads, through the
    custom op: CPU tensors take `attention_core_reference`; CUDA tensors
    launch the kernel (fp32 or bf16, dk 64 or 128, any T) or raise."""
    if q.device.type == "cpu" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return attention_core_reference(q, k, v, key_pad_mask, n_head)
    if q.device.type != "cpu":
        _checked(q, k, v, key_pad_mask, n_head)
        check_inference("flash_mha", q, k, v)
    return torch.ops.votw.attention_core(q, k, v, key_pad_mask, n_head)


def _checked(q, k, v, key_pad_mask, n_head: int) -> int:
    """Raise on what the kernel does not take; returns dk."""
    if q.device.type != "cuda":
        raise ValueError(f"attention_core: unsupported device {q.device}")
    B, T, HD = q.shape
    if HD % n_head:
        raise ValueError(f"H*dk={HD} not divisible by n_head={n_head}")
    dk = HD // n_head
    if dk not in _HEAD_DIMS:
        raise ValueError(f"attention_core kernel takes dk in {_HEAD_DIMS}; got {dk}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"attention_core kernel takes float32/bfloat16; got {q.dtype}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"attention_core: {name} {tuple(x.shape)} {x.dtype} "
                             f"{x.device} does not match q")
    if key_pad_mask is not None and (key_pad_mask.shape != (B, T)
                                     or key_pad_mask.device != q.device):
        raise ValueError(f"attention_core: key_pad_mask must be ({B}, {T}) on {q.device}")
    return dk


attention_core.launches = 0


@torch.library.custom_op("votw::attention_core", mutates_args=())
def _attention_core_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       key_pad_mask: Optional[torch.Tensor], n_head: int) -> torch.Tensor:
    raise ValueError(f"attention_core: unsupported device {q.device}")


@_attention_core_op.register_fake
def _(q, k, v, key_pad_mask, n_head):
    return torch.empty_like(q)


@_attention_core_op.register_kernel("cpu")
def _(q, k, v, key_pad_mask, n_head):
    return attention_core_reference(q, k, v, key_pad_mask, n_head)


@_attention_core_op.register_kernel("cuda")
def _attention_core_cuda(q, k, v, key_pad_mask, n_head):
    """The kernel's launch, with every check it needs."""
    B, T, HD = q.shape
    dk = _checked(q, k, v, key_pad_mask, n_head)
    mask = None if key_pad_mask is None else key_pad_mask.to(torch.uint8).contiguous()
    # the kernel loads 16-byte chunks: a view that starts off that grid is copied
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone()
               for x in (q.contiguous(), k.contiguous(), v.contiguous()))
    out = torch.empty_like(q)
    lib = _load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_mha_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            B, T, n_head, dk, _DTYPE_CODES[q.dtype], 1.0 / dk ** 0.5, stream)
    check_launch("flash_mha", err)
    attention_core.launches += 1
    return out


def _load_library() -> ctypes.CDLL:
    return load_library("flash_mha", {"flash_mha_fwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                                      + [ctypes.c_float, ctypes.c_void_p]})
