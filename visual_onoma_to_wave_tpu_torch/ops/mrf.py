"""One HiFi-GAN multi-receptive-field (MRF) stage: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel `visual_onoma_to_wave_tpu/ops/pallas_mrf.py::
mrf_stage_fused`. On x (B, C, T), per branch b with kernel size k_b and
dilations (d_0, d_1, d_2):

    y = x
    for d in dilations:
        h = conv_k,d(lrelu_0.1(y)) + bias       (zero padding at the edges of [0, T))
        y = y + conv_k,1(lrelu_0.1(h)) + bias
    out = (y_0 + y_1 + y_2) / 3

Operands are fp32 or bf16 (`dtype`): x, the weights and every conv input
are rounded to `dtype`, every product accumulates in fp32, the residual
streams stay fp32 and the output is rounded to `dtype`, as the TPU kernel
does (pallas_mrf.py:90-127).

Weights travel packed as in the TPU kernel (`pack_mrf_weights`): per branch
a (6, C, k*C) matrix holding its convs in execution order (conv1 of d_0,
conv2 of d_0, conv1 of d_1, ...) with A[co, j*C + ci] = W[co, ci, j] for a
Conv1d weight W (Cout, Cin, k), and the 18 biases as (18, C, 1) fp32.

The kernel reads a second layout built from that packing,
`pack_mrf_kernel_weights`: per branch the stream of (input-channel chunk,
tap) planes it fetches, in core-matrix order, fp32 as TF32 hi and lo
planes. `MRFStages` keeps both per stage of a generator and packs again
only when a weight changes; under `torch.export` it packs inside the traced
graph instead, so an exported program holds each weight once.

`mrf_stage_fused` calls the custom op `votw::mrf_stage_fused`
(`torch.library`, registered when this module is imported): its CUDA
implementation launches one of the three designs of `csrc/mrf.cu` (built at
first use by `ops/cuda_build.py`), its CPU implementation is
`mrf_stage_fused_reference`, and its fake implementation states the
output's shape, so `torch.export` records the op by name. `mrf_route` picks
the design from the width, the type and the input's size: in bf16 the
one-pass kernel at C 8-32 (one launch a stage, every conv of a frame tile
on chip, no scratch; `mrf_stage_onepass`) and the unit design at the widths
of `UNIT_WIDTHS` (one launch per residual unit with h in shared memory, then
the average: 4 launches a stage through 6 fp32 planes of residual stream;
`mrf_stage_unit`), each only where the stage gives it enough frame tiles
for the card's SMs; every other call the conv chain (8 launches a stage
through 7 fp32 scratch planes). It never falls back: any other device, a
CUDA tensor the kernel does not take (C outside 8/16/32/64/128/256/512,
other than three branches of three dilations, an even kernel size or one
above 11, a stage reaching further than `HALO` frames), a failed build, a
refused launch or a call that would need a gradient raises. Any T is taken:
the TPU kernel's t_tile % 128 and C-per-sublane rules are tiling rules of
the TPU. `mrf_stage_fused.launches` counts the stages the conv chain ran on
the card (one per call, which enqueues its 8 launches),
`mrf_stage_onepass.launches` those of the one-pass kernel and
`mrf_stage_unit.launches` those of the unit design (one per stage, which
enqueues its 4 launches).

What bounds the kernels on the card, and their designs, is written in
`csrc/mrf.cu`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from visual_onoma_to_wave_tpu_torch.ops.convnext import core_tiled, tf32_round
from visual_onoma_to_wave_tpu_torch.ops.cuda_build import (
    check_inference,
    check_launch,
    load_library,
)

HALO = 128          # the furthest one-sided reach of a stage the kernel takes, in frames
KERNEL_SIZES = (3, 7, 11)
DILATIONS = ((1, 3, 5),) * 3
SLOPE = 0.1
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_WIDTHS = (8, 16, 32, 64, 128, 256, 512)
_MAX_K = 11
# csrc/mrf.cu's tile: at most 128 output channels; input channels a weight
# stage (KC) and one wgmma k-step (KSTEP), both per operand type
_NT_MAX = 128
_KC_MAX = {torch.float32: 16, torch.bfloat16: 32}
_KSTEP = {torch.float32: 8, torch.bfloat16: 16}
# the one-pass design: the widths it is built for, those `mrf_route` sends to
# it (at C 64 the conv chain runs faster on an H100; chip_smoke phase 8 times
# both there), output frames a tile (each window adds _ONEPASS_HALO frames on
# both sides), and the reach it takes: of the stage, and of any one conv (the
# margin rows around its windows)
ONEPASS_KERNEL_WIDTHS = (8, 16, 32, 64)
ONEPASS_WIDTHS = (8, 16, 32)
_ONEPASS_TILE = {8: 896, 16: 896, 32: 384, 64: 128}
_ONEPASS_HALO, _ONEPASS_REACH = 64, 32
# the unit design (one launch per residual unit): the widths it is built
# for, those `mrf_route` sends to it (at C 128 and 256 the conv chain runs
# faster on an H100; chip_smoke phase 8 times both at each), output frames a
# tile, and the reach of a conv it takes (the margin rows around conv1's
# window)
UNIT_KERNEL_WIDTHS = (64, 128, 256)
UNIT_WIDTHS = (64,)
_UNIT_TILE = {64: 192, 128: 192, 256: 64}
_UNIT_REACH = 32
# The route's size rule: a design that puts a whole frame tile in one CTA
# takes a stage only when the stage has at least this many of its work
# items (`design_items`) per SM of the card; below that the chain's 8
# launches of smaller items run faster. Read from
# tools/mrf_onepass_widths_torch.py on an H100 (B 1 and 2 at short T, B 16
# at the served T): the one-pass kernel beats the chain from 1 item per SM
# at C 8-32 and loses at 0.5 (C 8, 16) or ties (C 32); the unit design at C
# 64 from 8 items per SM and loses at 2 (B 16 at the served T gives it 242).
MIN_ITEMS_PER_SM = {"onepass": 1.0, "unit": 8.0}
SMS = 132           # an H100 SXM's SMs: the count the route assumes without a card


def stage_halo(kernel_sizes=KERNEL_SIZES, dilations=DILATIONS) -> int:
    """One-sided receptive half-width of one MRF stage in frames."""
    return max(sum((d + 1) * (k - 1) // 2 for d in ds)
               for k, ds in zip(kernel_sizes, dilations))


def pack_mrf_weights(resblocks) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Pack one stage's `ResBlock1` modules (one per branch) for the kernel:
    ([A_0, A_1, A_2], biases), A_b (6, C, k_b*C) with A[co, j*C + ci] =
    W[co, ci, j] in execution order, biases (3*6, C, 1) fp32. Copies the
    weights: pack once per weight change, not per call."""
    mats, biases = [], []
    with torch.no_grad():
        for block in resblocks:
            rows = []
            for c1, c2 in zip(block.convs1, block.convs2):
                for conv in (c1, c2):
                    w = conv.weight.detach()                        # (Cout, Cin, k)
                    c, k = w.shape[0], w.shape[-1]
                    rows.append(w.permute(0, 2, 1).reshape(c, k * c))
                    biases.append(conv.bias.detach().float())
            mats.append(torch.stack(rows).contiguous())
        return mats, torch.stack(biases)[:, :, None].contiguous()


def kernel_tile(C: int, dtype: torch.dtype) -> tuple[int, int, int]:
    """(NT, KC, KCP) of `csrc/mrf.cu` at width C: output channels a tile,
    input channels a weight stage, and KC padded to one wgmma k-step (bf16 C
    8: 16, the upper 8 zero)."""
    nt = min(C, _NT_MAX)
    kc = min(nt, _KC_MAX[dtype])
    return nt, kc, max(kc, _KSTEP[dtype])


def tile_frames(C: int) -> int:
    """Frames of one tile of `csrc/mrf.cu` at width C: 128 * MB, MB = 1 (C >=
    128), 2 (C 64), 4 (C <= 32), each consumer warpgroup 64 * MB frames."""
    return 128 * (1 if C >= 128 else 2 if C == 64 else 4)


def onepass_tile_frames(C: int) -> int:
    """Output frames of one tile of the one-pass kernel at width C (its
    window is 64 frames more on each side, in 64-row wgmma tiles)."""
    return _ONEPASS_TILE[C]


def onepass_takes(C: int, dtype: torch.dtype, kernel_sizes=KERNEL_SIZES,
                  dilations=DILATIONS) -> bool:
    """Whether the one-pass kernel is built for the stage: bf16 at C 8-64,
    the stage reaching at most 64 frames and no conv further than 32 (every
    HiFi-GAN / iSTFTNet stage: 60 and 25)."""
    reach = max(((k - 1) // 2 * d for k, ds in zip(kernel_sizes, dilations) for d in ds),
                default=0)
    return dtype == torch.bfloat16 and C in ONEPASS_KERNEL_WIDTHS and \
        reach <= _ONEPASS_REACH and stage_halo(kernel_sizes, dilations) <= _ONEPASS_HALO


def unit_tile_frames(C: int) -> int:
    """Output frames of one tile of the unit design at width C (conv1
    computes 64 frames more, 32 on each side; its window 64 more on each
    side of those output frames)."""
    return _UNIT_TILE[C]


def unit_takes(C: int, dtype: torch.dtype, kernel_sizes=KERNEL_SIZES,
               dilations=DILATIONS) -> bool:
    """Whether the unit design is built for the stage: bf16 at C 64-256,
    three branches of three dilations, no conv reaching further than 32
    frames (every HiFi-GAN / iSTFTNet stage: 25)."""
    reach = max(((k - 1) // 2 * d for k, ds in zip(kernel_sizes, dilations) for d in ds),
                default=0)
    return dtype == torch.bfloat16 and C in UNIT_KERNEL_WIDTHS and len(kernel_sizes) == 3 \
        and len(dilations) == 3 and all(len(ds) == 3 for ds in dilations) and \
        reach <= _UNIT_REACH


def design_items(design: str, C: int, batch: int, frames: int) -> int:
    """Work items (one CTA's unit of work) of a stage of `batch` x `frames`
    in a design: the one-pass kernel's frame tiles (each all three
    branches), the unit design's frame tiles of each branch."""
    if design == "onepass":
        return batch * -(-frames // _ONEPASS_TILE[C])
    return 3 * batch * -(-frames // _UNIT_TILE[C])


def mrf_route(C: int, dtype: torch.dtype, kernel_sizes=KERNEL_SIZES, dilations=DILATIONS,
              batch: int | None = None, frames: int | None = None, sms: int = SMS) -> str:
    """The design of `csrc/mrf.cu` a CUDA call on x (batch, C, frames) takes:
    "onepass" where the one-pass kernel takes the stage and C is 8, 16 or 32,
    "unit" where the unit design takes it and C is in `UNIT_WIDTHS`, each
    only with at least `MIN_ITEMS_PER_SM` of its work items per SM (`sms`,
    the card's count); else "chain". Without `batch` and `frames` the width
    decides alone (a stage as large as the served ones)."""
    def enough(design: str) -> bool:
        return batch is None or frames is None or \
            design_items(design, C, batch, frames) >= MIN_ITEMS_PER_SM[design] * sms

    if C in ONEPASS_WIDTHS and onepass_takes(C, dtype, kernel_sizes, dilations) and \
            enough("onepass"):
        return "onepass"
    if C in UNIT_WIDTHS and unit_takes(C, dtype, kernel_sizes, dilations) and enough("unit"):
        return "unit"
    return "chain"


def pack_mrf_kernel_weights(mats, dtype: torch.dtype = torch.float32) -> list[torch.Tensor]:
    """`pack_mrf_weights`'s (6, C, k*C) matrices as the kernel streams them:
    per branch a flat tensor of `dtype` laid out (conv, C / NT output-channel
    tiles, C / KC input-channel chunks, k taps, SPLIT, NT * KCP), each plane
    the (NT, KCP) block A_j^T of one tap, K-major in 8-row x 16-byte core
    matrices (rows inside a core, cores along N, then along K). fp32: SPLIT
    2, the plane hi = `tf32_round(w)` then lo = w - hi (hi + lo == w); bf16:
    SPLIT 1, with zero columns past KC. Copies the weights: pack once per
    weight change, not per call."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"pack_mrf_kernel_weights takes float32/bfloat16; got {dtype}")
    packed = []
    with torch.no_grad():
        for a in mats:
            C = a.shape[1]
            k = a.shape[2] // C
            if C not in _WIDTHS or tuple(a.shape) != (6, C, k * C):
                raise ValueError(f"pack_mrf_kernel_weights takes (6, C, k*C) with C in {_WIDTHS}; "
                                 f"got {tuple(a.shape)}")
            nt, kc, kcp = kernel_tile(C, dtype)
            # A[conv, co, j * C + ci] -> [conv, co tile, co, j, ci chunk, ci]
            w = a.detach().to(dtype).reshape(6, C // nt, nt, k, C // kc, kc)
            if kcp > kc:
                w = F.pad(w, (0, kcp - kc))
            w = core_tiled(w.permute(0, 1, 4, 3, 2, 5), 16 // w.element_size())
            if dtype == torch.float32:
                hi = tf32_round(w)
                w = torch.stack([hi, w - hi], dim=-2)
            packed.append(w.reshape(-1).contiguous())
    return packed


def kernel_weights_numel(C: int, k: int, dtype: torch.dtype) -> int:
    """Elements of one branch's `pack_mrf_kernel_weights` stream."""
    nt, kc, kcp = kernel_tile(C, dtype)
    return 6 * k * C * kcp * (C // kc) * (2 if dtype == torch.float32 else 1)


def mrf_stage_fused_reference(x: torch.Tensor, w3: torch.Tensor, w7: torch.Tensor,
                              w11: torch.Tensor, biases: torch.Tensor,
                              kernel_sizes=KERNEL_SIZES, dilations=DILATIONS,
                              dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the 18-conv chain in `F.conv1d`
    (tests/test_pallas_mrf.py::_xla_stage). Returns (B, C, T) in `dtype`
    (x.dtype by default)."""
    dtype = dtype or x.dtype

    def rnd(t: torch.Tensor) -> torch.Tensor:
        # bf16 operands: products of bf16 values are exact in fp32, so fp32
        # convs of the rounded operands are bf16 products with fp32 sums
        return t.to(dtype).float()

    C = x.shape[1]
    bias = biases.reshape(-1, C).float()
    x32 = rnd(x)
    acc = None
    for b, (a, k, ds) in enumerate(zip((w3, w7, w11), kernel_sizes, dilations)):
        # (6, Cout, Cin, k), contiguous as a Conv1d weight is
        w = rnd(a).reshape(2 * len(ds), C, k, C).permute(0, 1, 3, 2).contiguous()
        y = x32
        for i, d in enumerate(ds):
            h = F.conv1d(rnd(F.leaky_relu(y, SLOPE)), w[2 * i], bias[6 * b + 2 * i],
                         padding=d * (k - 1) // 2, dilation=d)
            h = F.conv1d(rnd(F.leaky_relu(h, SLOPE)), w[2 * i + 1], bias[6 * b + 2 * i + 1],
                         padding=(k - 1) // 2)
            y = y + h
        acc = y if acc is None else acc + y
    return (acc / len(kernel_sizes)).to(dtype)


def _checked(x, mats, biases, kernel_sizes, dilations, dtype, packed=None) -> None:
    """Raise on what the kernel does not take; the device is checked last."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"mrf_stage_fused kernel takes float32/bfloat16; got {dtype}")
    if x.dim() != 3:
        raise ValueError(f"mrf_stage_fused takes x as (B, C, T); got {tuple(x.shape)}")
    C = x.shape[1]
    if C not in _WIDTHS:
        raise ValueError(f"mrf_stage_fused kernel takes C in {_WIDTHS}; got {C}")
    if packed is not None and len(packed) != 3:
        raise ValueError(f"mrf_stage_fused: {len(packed)} packed branches, expected 3")
    if len(kernel_sizes) != 3 or any(len(ds) != 3 for ds in dilations) or len(dilations) != 3:
        raise ValueError("mrf_stage_fused kernel takes three branches of three dilations; got "
                         f"kernel_sizes {kernel_sizes}, dilations {dilations}")
    if any(k % 2 == 0 or not 1 <= k <= _MAX_K for k in kernel_sizes):
        raise ValueError(f"mrf_stage_fused kernel takes odd kernel sizes up to {_MAX_K}; "
                         f"got {kernel_sizes}")
    if any(d < 1 for ds in dilations for d in ds):
        raise ValueError(f"mrf_stage_fused: dilations must be >= 1; got {dilations}")
    if stage_halo(kernel_sizes, dilations) > HALO:
        raise ValueError(f"stage receptive field {stage_halo(kernel_sizes, dilations)} "
                         f"exceeds the kernel's {HALO}-frame halo")
    for a, k in zip(mats, kernel_sizes):
        if tuple(a.shape) != (6, C, k * C) or a.device != x.device:
            raise ValueError(f"mrf_stage_fused: weights {tuple(a.shape)} on {a.device} do not "
                             f"fit x {tuple(x.shape)} on {x.device} (expected (6, {C}, {k * C}))")
    if biases.numel() != 18 * C or biases.device != x.device:
        raise ValueError(f"mrf_stage_fused: biases {tuple(biases.shape)} on {biases.device} "
                         f"do not fit (18, {C}, 1)")
    if packed is not None:
        for p, k in zip(packed, kernel_sizes):
            if p.dtype != dtype or p.numel() != kernel_weights_numel(C, k, dtype) or \
                    p.device != x.device or not p.is_contiguous():
                raise ValueError(f"mrf_stage_fused: packed weights {tuple(p.shape)} {p.dtype} on "
                                 f"{p.device} do not fit C {C}, k {k}, {dtype} on {x.device} "
                                 "(pack_mrf_kernel_weights)")
    if x.device.type != "cuda":
        raise ValueError(f"mrf_stage_fused: unsupported device {x.device}")


def _load_library() -> ctypes.CDLL:
    # chain: 7 pointers; batch, C, T, 3 kernel sizes, 9 dilations, dtype;
    # stream. One pass: 6 pointers; the same ints but the dtype; stream.
    # Unit: 7 pointers; the one pass's ints; stream
    return load_library("mrf", {
        "mrf_stage_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 16 + [ctypes.c_void_p],
        "mrf_stage_onepass_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 15 + [ctypes.c_void_p],
        "mrf_stage_unit_fwd": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15 + [ctypes.c_void_p]})


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device, which `mrf_route` holds tile counts against."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def mrf_stage_fused(x: torch.Tensor, w3: torch.Tensor, w7: torch.Tensor, w11: torch.Tensor,
                    biases: torch.Tensor, kernel_sizes=KERNEL_SIZES, dilations=DILATIONS,
                    dtype: torch.dtype | None = None,
                    packed: list[torch.Tensor] | None = None) -> torch.Tensor:
    """One MRF stage. x: (B, C, T); weights from `pack_mrf_weights`; returns
    (B, C, T) in `dtype` (x.dtype by default), through the custom op: CPU
    tensors take `mrf_stage_fused_reference`; CUDA tensors launch the kernel
    or raise. `packed`: the weights' `pack_mrf_kernel_weights(.., dtype)`,
    packed here when not given. A CPU call that needs a gradient takes the
    plain version directly (the op has no backward)."""
    if x.device.type == "cpu" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w3, w7, w11, biases)):
        return mrf_stage_fused_reference(x, w3, w7, w11, biases, kernel_sizes, dilations, dtype)
    kernel_sizes = [int(k) for k in kernel_sizes]
    dilations = [int(d) for ds in dilations for d in ds]
    if x.device.type != "cpu":
        _checked(x, (w3, w7, w11), biases, *_nested(kernel_sizes, dilations), dtype or x.dtype,
                 packed)
        check_inference("mrf_stage", x, w3, w7, w11, biases)
    return torch.ops.votw.mrf_stage_fused(x, w3, w7, w11, biases, kernel_sizes, dilations,
                                          dtype, list(packed or ()))


mrf_stage_fused.launches = 0


@torch.library.custom_op("votw::mrf_stage_fused", mutates_args=())
def _mrf_stage_op(x: torch.Tensor, w3: torch.Tensor, w7: torch.Tensor, w11: torch.Tensor,
                  biases: torch.Tensor, kernel_sizes: list[int], dilations: list[int],
                  dtype: Optional[torch.dtype], packed: list[torch.Tensor]) -> torch.Tensor:
    raise ValueError(f"mrf_stage_fused: unsupported device {x.device}")


def _nested(kernel_sizes, dilations):
    """The op's flat dilations as one tuple of three per branch."""
    n = len(dilations) // max(len(kernel_sizes), 1)
    return (tuple(int(k) for k in kernel_sizes),
            tuple(tuple(int(d) for d in dilations[i:i + n])
                  for i in range(0, len(dilations), n)))


@_mrf_stage_op.register_fake
def _(x, w3, w7, w11, biases, kernel_sizes, dilations, dtype, packed):
    return x.new_empty(x.shape, dtype=dtype or x.dtype)


@_mrf_stage_op.register_kernel("cpu")
def _(x, w3, w7, w11, biases, kernel_sizes, dilations, dtype, packed):
    return mrf_stage_fused_reference(x, w3, w7, w11, biases, *_nested(kernel_sizes, dilations),
                                     dtype)


@_mrf_stage_op.register_kernel("cuda")
def _mrf_stage_cuda(x, w3, w7, w11, biases, kernel_sizes, dilations, dtype, packed):
    """The stage on the card, by `mrf_route` on x's shape: the one-pass
    kernel, the unit design or the conv chain, with every check they need."""
    dtype = dtype or x.dtype
    kernel_sizes, dilations = _nested(kernel_sizes, dilations)
    packed = packed or None
    _checked(x, (w3, w7, w11), biases, kernel_sizes, dilations, dtype, packed)
    if packed is None:
        packed = pack_mrf_kernel_weights((w3, w7, w11), dtype)
    xk = x.to(dtype).contiguous()
    bias = biases.float().contiguous()
    B, C, T = x.shape
    route = mrf_route(C, dtype, kernel_sizes, dilations, B, T, sm_count(x.device))
    if route == "onepass":
        return mrf_stage_onepass(xk, packed, bias, kernel_sizes, dilations)
    if route == "unit":
        return mrf_stage_unit(xk, packed, bias, kernel_sizes, dilations)
    return _mrf_stage_chain(xk, packed, bias, kernel_sizes, dilations)


def _mrf_stage_chain(xk, packed, bias, kernel_sizes, dilations):
    """The conv chain's 8 launches of one stage on checked operands: `xk`
    (B, C, T) in the operand type, its `pack_mrf_kernel_weights` stream, the
    biases fp32."""
    B, C, T = xk.shape
    dtype = xk.dtype
    out = torch.empty(B, C, T, dtype=dtype, device=xk.device)
    # x channels-last, then per branch its residual stream y_b and its conv1
    # output h_b, all (B, T, C) fp32
    scratch = torch.empty(7, B, T, C, dtype=torch.float32, device=xk.device)
    lib = _load_library()
    with torch.cuda.device(xk.device):
        stream = torch.cuda.current_stream(xk.device).cuda_stream
        err = lib.mrf_stage_fwd(
            xk.data_ptr(), out.data_ptr(), scratch.data_ptr(), *(p.data_ptr() for p in packed),
            bias.data_ptr(), B, C, T, *kernel_sizes, *(d for ds in dilations for d in ds),
            _DTYPE_CODES[dtype], stream)
    check_launch("mrf_stage", err)
    mrf_stage_fused.launches += 1
    return out


def _bf16_design_operands(name: str, x: torch.Tensor, packed, biases, kernel_sizes,
                          dilations, takes: bool, what: str):
    """Raise on anything a bf16 design (`name`) does not take; returns x,
    copied where its data does not start on 16 bytes (the kernels' 16-byte
    loads). `takes`: whether the design is built for the stage, `what` says
    what it is built for."""
    if x.dim() != 3 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"{name} takes contiguous bf16 (B, C, T); got "
                         f"{tuple(x.shape)} {x.dtype}")
    C = x.shape[1]
    if len(kernel_sizes) != 3 or any(len(ds) != 3 for ds in dilations) or \
            len(dilations) != 3 or any(k % 2 == 0 or not 1 <= k <= _MAX_K for k in kernel_sizes) \
            or any(d < 1 for ds in dilations for d in ds):
        raise ValueError(f"{name} takes three branches of three dilations >= 1 and "
                         f"odd kernel sizes up to {_MAX_K}; got {kernel_sizes}, {dilations}")
    if not takes:
        raise ValueError(f"{name} takes {what}; got C {C}, kernel_sizes {kernel_sizes}, "
                         f"dilations {dilations}")
    if len(packed) != 3 or any(
            p.dtype != x.dtype or p.numel() != kernel_weights_numel(C, k, x.dtype) or
            p.device != x.device or not p.is_contiguous() for p, k in zip(packed, kernel_sizes)):
        raise ValueError(f"{name}: packed weights do not fit "
                         "(pack_mrf_kernel_weights in bf16, three branches)")
    if biases.dtype != torch.float32 or biases.numel() != 18 * C or \
            biases.device != x.device or not biases.is_contiguous():
        raise ValueError(f"{name}: biases {tuple(biases.shape)} {biases.dtype} do "
                         f"not fit (18, {C}, 1) fp32")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.clone() if x.data_ptr() % 16 else x


def mrf_stage_onepass(x: torch.Tensor, packed: list[torch.Tensor], biases: torch.Tensor,
                      kernel_sizes=KERNEL_SIZES, dilations=DILATIONS) -> torch.Tensor:
    """The one-pass kernel's launch: x (B, C, T) bf16 contiguous on the card,
    `packed` its bf16 `pack_mrf_kernel_weights` stream, biases fp32 (18 *
    C); returns (B, C, T) bf16. Raises on anything the kernel does not take
    (`onepass_takes`). `mrf_stage_fused` reaches it through the custom op
    where `mrf_route` sends the stage here; chip_smoke also times it at C 64
    beside the conv chain."""
    kernel_sizes = tuple(int(k) for k in kernel_sizes)
    dilations = tuple(tuple(int(d) for d in ds) for ds in dilations)
    takes = x.dim() == 3 and onepass_takes(x.shape[1], x.dtype, kernel_sizes, dilations)
    x = _bf16_design_operands(
        "mrf_stage_onepass", x, packed, biases, kernel_sizes, dilations, takes,
        f"bf16 at C in {ONEPASS_KERNEL_WIDTHS} within a stage reach of {_ONEPASS_HALO} frames "
        f"and a conv reach of {_ONEPASS_REACH}")
    B, C, T = x.shape
    out = torch.empty_like(x)
    lib = _load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mrf_stage_onepass_fwd(
            x.data_ptr(), out.data_ptr(), *(p.data_ptr() for p in packed), biases.data_ptr(),
            B, C, T, *kernel_sizes, *(d for ds in dilations for d in ds), stream)
    check_launch("mrf_stage_onepass", err)
    mrf_stage_onepass.launches += 1
    return out


mrf_stage_onepass.launches = 0


def mrf_stage_unit(x: torch.Tensor, packed: list[torch.Tensor], biases: torch.Tensor,
                   kernel_sizes=KERNEL_SIZES, dilations=DILATIONS) -> torch.Tensor:
    """The unit design's launches (one per dilation, then the average): x
    (B, C, T) bf16 contiguous on the card, `packed` its bf16
    `pack_mrf_kernel_weights` stream, biases fp32 (18 * C); returns (B, C,
    T) bf16. Raises on anything the design does not take (`unit_takes`).
    `mrf_stage_fused` reaches it through the custom op where `mrf_route`
    sends the stage here; chip_smoke times it beside the conv chain at every
    width it is built for."""
    kernel_sizes = tuple(int(k) for k in kernel_sizes)
    dilations = tuple(tuple(int(d) for d in ds) for ds in dilations)
    takes = x.dim() == 3 and unit_takes(x.shape[1], x.dtype, kernel_sizes, dilations)
    x = _bf16_design_operands(
        "mrf_stage_unit", x, packed, biases, kernel_sizes, dilations, takes,
        f"bf16 at C in {UNIT_KERNEL_WIDTHS} within a conv reach of {_UNIT_REACH} frames")
    B, C, T = x.shape
    out = torch.empty_like(x)
    # each branch's residual stream, twice (a unit reads one set, writes the
    # other), (B, T, C) fp32
    scratch = torch.empty(6, B, T, C, dtype=torch.float32, device=x.device)
    lib = _load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mrf_stage_unit_fwd(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(), *(p.data_ptr() for p in packed),
            biases.data_ptr(), B, C, T, *kernel_sizes, *(d for ds in dilations for d in ds),
            stream)
    check_launch("mrf_stage_unit", err)
    mrf_stage_unit.launches += 1
    return out


mrf_stage_unit.launches = 0


class MRFStages:
    """The MRF stages of a generator whose stages are `ResBlock1` branches:
    stage i of `blocks` runs through the op `mrf_stage_fused` (the kernel on
    CUDA tensors, its plain version on the CPU), with its weights packed once
    (`pack_mrf_weights`, then on the card `pack_mrf_kernel_weights` in x's
    type) and packed again only when a weight changed (a new tensor, or an
    in-place write such as `load_state_dict`, which bumps its version
    counter); under `torch.export` the packing is traced into the graph. With
    `fused=False` (a generator in `.train()`: the kernel has no backward), and
    on the CPU for a stage of other than three branches or in bf16, the
    branches run as modules and are averaged. In bf16 the modules are the JAX
    generators' bf16 chain (JAX hifigan.py:36-67: every conv output rounded
    once, the residual sums in bf16), which the kernel's plain version, kept
    to the kernel's arithmetic (fp32 residual streams), is not."""

    def __init__(self, kernel_sizes=KERNEL_SIZES, dilations=DILATIONS):
        self.kernel_sizes = tuple(kernel_sizes)
        self.dilations = tuple(tuple(ds) for ds in dilations)
        self._packed: dict[int, tuple] = {}   # stage -> (identity, (mats, biases, packed))

    @staticmethod
    def pack(blocks, dtype: torch.dtype, device_type: str):
        """(mats, biases, kernel stream or None on the CPU) of one stage."""
        mats, biases = pack_mrf_weights(blocks)
        return mats, biases, (pack_mrf_kernel_weights(mats, dtype) if device_type == "cuda"
                              else None)

    def packed(self, i: int, blocks, dtype: torch.dtype, device_type: str = "cuda"):
        params = list(blocks.parameters())
        if torch.compiler.is_exporting():    # fake tensors: no identity to key a cache on
            return self.pack(blocks, dtype, device_type)
        key = (dtype, device_type, tuple((p.data_ptr(), p._version) for p in params))
        cached = self._packed.get(i)
        if cached is None or cached[0] != key:
            cached = (key, self.pack(blocks, dtype, device_type))
            self._packed[i] = cached
        return cached[1]

    def __call__(self, i: int, blocks, x: torch.Tensor, fused: bool = True) -> torch.Tensor:
        # the op takes three branches; on the CPU a stage of another shape,
        # or in bf16, runs as modules
        if fused and (x.device.type != "cpu" or (len(self.kernel_sizes) == 3
                                                 and x.dtype == torch.float32)):
            mats, biases, packed = self.packed(i, blocks, x.dtype, x.device.type)
            return mrf_stage_fused(x, *mats, biases, self.kernel_sizes, self.dilations,
                                   packed=packed)
        acc = None
        for block in blocks:
            y = block(x)
            acc = y if acc is None else acc + y
        return acc / len(blocks)
