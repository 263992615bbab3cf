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

`convnext_block` calls the custom op `votw::convnext_block` (`torch.library`,
registered when this module is imported): its CUDA implementation launches
the block kernel, its CPU implementation is `convnext_block_reference`, and
its fake implementation states the output's shape, so `torch.export` records
the op by name. `convnext_trunk`, which only `models/vocos.py::apply_fused`
calls, stays a plain function: it launches the trunk kernel for tensors on
the card and takes `convnext_trunk_reference` on the CPU. Both kernels are
in `csrc/convnext.cu`, built at first use by `ops/cuda_build.py`. Neither
falls back: any other device, a CUDA tensor the kernels do
not take (C other than 128, 256 or 512; M not a multiple of 128; even K or
K over 35), a
failed build, a refused launch or a call that would need a gradient
raises. Any T is taken: the TPU kernels'
T % 16, C % 128 and M % 128 are tiling rules of the TPU, not of the math.
Each wrapper counts its kernel launches in `.launches`.

The kernels run both products on Hopper's tensor cores (wgmma): fp32 as
3xTF32 (each operand split into a TF32 high part and its fp32 remainder;
three products hi*lo + lo*hi + hi*hi, fp32 accumulation), bf16 as one bf16
product. They read W1 and W2 as one stream of K-major planes that
`pack_convnext_weights` makes (plain PyTorch, runs on the CPU too); the
wrappers take it as `packed=` and pack per call without it, so callers that
keep their weights (`models/vocos.py`) pack once per weight change. What
bounds the kernels on the card, and why the trunk is a cooperative
persistent kernel, is written in `csrc/convnext.cu`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

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
_K_MAX = 35   # the conv's staged rows and taps fit the GELU chunk's shared memory
# the kernel's tiling of the weight stream (csrc/convnext.cu: MC, PLANE_BYTES)
_MC = 64
_PLANE_BYTES = 16384


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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 explicit mantissa bits) to nearest, ties away
    from zero: what `cvt.rna.tf32.f32` gives. The low 13 bits are zero."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def core_tiled(b: torch.Tensor, ck: int) -> torch.Tensor:
    """(..., N, K) -> (..., N * K): 8-row x `ck`-column core matrices (16
    bytes a row), rows inside a core, cores along N, then along K."""
    *lead, N, K = b.shape
    b = b.reshape(*lead, N // 8, 8, K // ck, ck).movedim(-2, -4)
    return b.reshape(*lead, N * K)


def pack_convnext_weights(w1: torch.Tensor, w2: torch.Tensor,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """W1 (C, M) and W2 (M, C), or stacked (L, C, M) and (L, M, C), as the
    kernels read them: per layer one stream of 16 KB planes in the order the
    kernel consumes them. For each chunk of 64 intermediate features, first
    the planes of W1^T (two 64-row blocks, one slice of each half of C),
    then those of W2^T (C rows x 64 / S2 columns), each block K-major in
    8-row x 16-byte core matrices. fp32: every plane is followed by its lo
    plane, with hi = `tf32_round(w)` and lo = w - hi exactly (hi + lo == w);
    bf16: one plane. Returns a contiguous tensor of `dtype`, (L, 4 * C * M)
    fp32 or (L, 2 * C * M) bf16, without the L axis for one block. Copies
    the weights: pack once per weight change, not per call."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"pack_convnext_weights takes float32/bfloat16; got {dtype}")
    C, M = w1.shape[-2:]
    if C not in _WIDTHS or M % _M_STEP or tuple(w2.shape[-2:]) != (M, C):
        raise ValueError(f"pack_convnext_weights takes w1 (.., C, M), w2 (.., M, C) with C in "
                         f"{_WIDTHS} and M a multiple of {_M_STEP}; got {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)}")
    lead = tuple(w1.shape[:-2])
    with torch.no_grad():
        w1 = w1.detach().to(dtype).reshape(-1, C, M)
        w2 = w2.detach().to(dtype).reshape(-1, M, C)
        L, J, size = w1.shape[0], M // _MC, torch.empty((), dtype=dtype).element_size()
        plane, ck = _PLANE_BYTES // size, 16 // size
        ks1, ks2 = plane // _MC, plane // C
        # W1^T (L, M, C) -> (L, J, S1, 2, MC, KS1 / 2): a stage holds one slice of
        # each half of C; W2^T (L, C, M) -> (L, J, S2, C, KS2)
        b1 = w1.transpose(1, 2).reshape(L, J, _MC, 2, C // ks1, ks1 // 2)
        b1 = core_tiled(b1.permute(0, 1, 4, 3, 2, 5), ck).reshape(L, J, C // ks1, plane)
        b2 = w2.transpose(1, 2).reshape(L, C, J, _MC // ks2, ks2).permute(0, 2, 3, 1, 4)
        stream = torch.cat([b1, core_tiled(b2, ck)], dim=2)
        if dtype == torch.float32:
            hi = tf32_round(stream)
            stream = torch.stack([hi, stream - hi], dim=3)
        return stream.reshape(*lead, -1).contiguous()


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


def _operands(name: str, L: int, x, dw, db, ls, lb, w1, b1, w2, b2, gamma, packed):
    """Check the weights against x and return the kernel operands, contiguous:
    dw (L, K, C) in x's dtype, the packed weight stream (packed here if not
    given), the vectors in fp32, and K."""
    C, M = x.shape[-1], w1.shape[-1]
    K = dw.numel() // (L * C)
    sizes = {"dw": (dw, L * K * C), "db": (db, L * C), "ls": (ls, L * C), "lb": (lb, L * C),
             "w1": (w1, L * C * M), "b1": (b1, L * M), "w2": (w2, L * M * C),
             "b2": (b2, L * C), "gamma": (gamma, L * C)}
    for arg, (t, n) in sizes.items():
        if t.numel() != n or t.device != x.device:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} on {t.device} does not fit "
                             f"x {tuple(x.shape)} on {x.device} (L={L}, M={M})")
    if K % 2 == 0 or K > _K_MAX:
        raise ValueError(f"{name} kernel takes an odd kernel size up to {_K_MAX}; got {K}")
    if packed is None:
        packed = pack_convnext_weights(w1.reshape(L, C, M), w2.reshape(L, M, C), x.dtype)
    n = L * C * M * (4 if x.dtype == torch.float32 else 2)
    if packed.dtype != x.dtype or packed.numel() != n or packed.device != x.device:
        raise ValueError(f"{name}: packed weights {packed.dtype} {packed.numel()} on "
                         f"{packed.device} do not fit x {x.dtype} on {x.device} (need {n}; "
                         f"pack_convnext_weights(w1, w2, x.dtype))")
    ops = [dw.to(x.dtype).contiguous(), packed.contiguous()]
    ops += [t.float().contiguous() for t in (db, ls, lb, b1, b2, gamma)]
    return ops, K


def _load_library() -> ctypes.CDLL:
    # block: 10 pointers, 7 ints (B, T, C, M, K, dtype, gelu_tanh), eps, stream;
    # trunk: + scratch and sync pointers, + layers int
    tail = [ctypes.c_float, ctypes.c_void_p]
    return load_library("convnext", {
        "convnext_block_fwd": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + tail,
        "convnext_trunk_fwd": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 + tail,
    })


def convnext_block(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps: float = 1e-6,
                   gelu_approximate: bool = True, packed: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """One ConvNeXt block, through the custom op. x: (B, T, C); dw (K, 1, C)
    or (K, C); w1 (C, M); w2 (M, C); db, ls, lb, b2, gamma (C,); b1 (M,).
    `packed`: `pack_convnext_weights(w1, w2, x.dtype)`, packed here if not
    given. CPU tensors take `convnext_block_reference`; CUDA tensors launch
    the kernel or raise. A CPU call that needs a gradient takes the plain
    version directly (the op has no backward)."""
    weights = (dw, db, ls, lb, w1, b1, w2, b2, gamma)
    if x.device.type == "cpu" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, *weights)):
        return convnext_block_reference(x, *weights, eps, gelu_approximate)
    if x.device.type != "cpu":
        _checked(x, w1, "convnext_block")
        check_inference("convnext_block", x, *weights)
    return torch.ops.votw.convnext_block(x, *weights, float(eps), bool(gelu_approximate),
                                         packed)


convnext_block.launches = 0


@torch.library.custom_op("votw::convnext_block", mutates_args=())
def _convnext_block_op(x: torch.Tensor, dw: torch.Tensor, db: torch.Tensor, ls: torch.Tensor,
                       lb: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                       b2: torch.Tensor, gamma: torch.Tensor, eps: float,
                       gelu_approximate: bool, packed: Optional[torch.Tensor]) -> torch.Tensor:
    raise ValueError(f"convnext_block: unsupported device {x.device}")


@_convnext_block_op.register_fake
def _(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps, gelu_approximate, packed):
    return torch.empty_like(x)


@_convnext_block_op.register_kernel("cpu")
def _(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps, gelu_approximate, packed):
    return convnext_block_reference(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps,
                                    gelu_approximate)


@_convnext_block_op.register_kernel("cuda")
def _convnext_block_cuda(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps, gelu_approximate,
                         packed):
    """The block kernel's launch, with every check it needs."""
    _checked(x, w1, "convnext_block")
    B, T, C = x.shape
    M = w1.shape[-1]
    (dw, packed, db, ls, lb, b1, b2, gamma), K = _operands(
        "convnext_block", 1, x, dw, db, ls, lb, w1, b1, w2, b2, gamma, packed)
    x = x.contiguous()
    y = torch.empty_like(x)
    lib = _load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.convnext_block_fwd(
            x.data_ptr(), y.data_ptr(), dw.data_ptr(), db.data_ptr(), ls.data_ptr(),
            lb.data_ptr(), packed.data_ptr(), b1.data_ptr(), b2.data_ptr(), gamma.data_ptr(),
            B, T, C, M, K, _DTYPE_CODES[x.dtype], int(gelu_approximate), eps, stream)
    check_launch("convnext_block", err)
    convnext_block.launches += 1
    return y


def convnext_trunk(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps: float = 1e-6,
                   gelu_approximate: bool = True, packed: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """All L blocks in one launch. x: (B, T, C); weights stacked on a leading
    L axis: dw (L, K, 1, C) or (L, K, C); w1 (L, C, M); w2 (L, M, C); db, ls,
    lb, b2, gamma (L, C); b1 (L, M). `packed`: `pack_convnext_weights(w1, w2,
    x.dtype)`, packed here if not given. Equals L `convnext_block` calls. CPU
    tensors take `convnext_trunk_reference`; CUDA tensors launch the kernel
    or raise."""
    if x.device.type == "cpu":
        return convnext_trunk_reference(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps,
                                        gelu_approximate)
    _checked(x, w1, "convnext_trunk")
    check_inference("convnext_trunk", x, dw, db, ls, lb, w1, b1, w2, b2, gamma)
    B, T, C = x.shape
    L, M = w1.shape[0], w1.shape[-1]
    (dw, packed, db, ls, lb, b1, b2, gamma), K = _operands(
        "convnext_trunk", L, x, dw, db, ls, lb, w1, b1, w2, b2, gamma, packed)
    x = x.contiguous()
    y = torch.empty_like(x)
    scratch = torch.empty_like(x)   # the activation ping-pongs between y and scratch
    sync = torch.zeros(1, dtype=torch.int32, device=x.device)   # the grid barrier's counter
    lib = _load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.convnext_trunk_fwd(
            x.data_ptr(), y.data_ptr(), scratch.data_ptr(), sync.data_ptr(), dw.data_ptr(),
            db.data_ptr(), ls.data_ptr(), lb.data_ptr(), packed.data_ptr(), b1.data_ptr(),
            b2.data_ptr(), gamma.data_ptr(), L, B, T, C, M, K, _DTYPE_CODES[x.dtype],
            int(gelu_approximate), eps, stream)
    check_launch("convnext_trunk", err)
    convnext_trunk.launches += 1
    return y


convnext_trunk.launches = 0
