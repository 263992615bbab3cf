"""B7: a 1-D convolution with SAME padding on feature-last input, with its
epilogue: CUDA kernel + plain PyTorch version.

Replaces no TPU kernel: the JAX package runs the acoustic model's conv FFNs
and PostNet through XLA. On the card they ran through cuDNN's fp32 path,
which with TF32 off is a SIMT implicit GEMM on the CUDA cores, on
channels-first data with a transpose around every conv; B7 runs them at fp32
accuracy on the tensor cores (3xTF32) on the models' own (B, T, C) layout.
What bounds it and its design are written in `csrc/conv1d_tc.cu`.

On x (B, T, cin) fp32, a Conv1d weight (cout, cin, k) with k odd and its bias:

    v = conv(x, weight, padding (k - 1) / 2) + bias
    v = (v - mean) * (1 / sqrt(var + eps)) * gamma + beta   (bn: an eval BatchNorm)
    y = v, relu(v) or tanh(v)                               (act)

returned as (B, T, cout) fp32. `conv1d_tc_reference` is the plain version,
the same arithmetic as a channels-last implicit GEMM (the k taps of each
frame unfolded beside its channels, one fp32 product with the weight).

`conv1d_tc` calls the custom op `votw::conv1d_tc` (`torch.library`,
registered when this module is imported): its CUDA implementation launches
the kernel (`csrc/conv1d_tc.cu`, built at first use by `ops/cuda_build.py`),
its CPU implementation is `conv1d_tc_reference`, and its fake implementation
states the output's shape, so `torch.export` records the op by name. The op
never falls back: a CUDA tensor the kernel does not take (cin not a multiple
of 16, cout neither a multiple of 128 nor 80, an even k or one above 31, a
type other than fp32), a CUDA call without the packed weight, a failed
build, a refused launch or a call that would need a gradient raises.
`conv1d_tc.launches` counts its launches.

The kernel reads the weight as `pack_conv1d_weight` packs it. For the models'
convs `kernel_weight` packs it once and holds it as the conv's non-persistent
buffer `kernel_weight`, packed again only when the weight changes (a new
tensor, a move, or an in-place write such as `load_state_dict`, which bumps
its version counter); `torch.export` takes that buffer into the program as
it stands, so an exported program packs nothing per call.

`runs_kernel` is the one rule for which convs take the kernel: on the card,
in `.eval()`, at fp32 compute. Everything else runs as today: `.train()`
through cuDNN with autograd (the kernel has no backward), the bf16 compute
dtype through cuDNN's bf16 convs, the CPU through the modules. The rule
looks at no width: a conv it sends that the kernel does not take raises
(`conv1d_module`), and does not fall back to cuDNN.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from visual_onoma_to_wave_tpu_torch.ops.convnext import core_tiled, tf32_round
from visual_onoma_to_wave_tpu_torch.ops.cuda_build import (
    check_inference,
    check_launch,
    load_library,
)

KC = 16             # input channels a chunk of the kernel's K
KMAX = 31           # the largest kernel size it takes
ACTS = {"none": 0, "relu": 1, "tanh": 2}


def tile_n(cout: int) -> int | None:
    """Output channels of one tile of the kernel at `cout`: 128 where cout is
    a multiple of 128, 80 at cout 80 (the PostNet's last conv); None where
    the kernel has no tile."""
    if cout > 0 and cout % 128 == 0:
        return 128
    return 80 if cout == 80 else None


def conv1d_tc_takes(cin: int, cout: int, k: int) -> bool:
    """Whether the kernel takes a conv of these widths and kernel size."""
    return (cin > 0 and cin % KC == 0 and tile_n(cout) is not None and 1 <= k <= KMAX and
            k % 2 == 1)


def module_takes(conv: nn.Module) -> bool:
    """Whether `conv` is a Conv1d the kernel computes: SAME padding (odd k),
    stride, dilation and groups 1, a bias, widths the kernel takes."""
    return (isinstance(conv, nn.Conv1d) and conv.bias is not None and conv.padding == "same" and
            conv.stride == (1,) and conv.dilation == (1,) and conv.groups == 1 and
            conv.padding_mode == "zeros" and
            conv1d_tc_takes(conv.in_channels, conv.out_channels, conv.kernel_size[0]))


def runs_kernel(device: torch.device, dtype: torch.dtype, training: bool) -> bool:
    """The route of a group of convs (a conv FFN, a PostNet) that compute at
    `dtype`: the kernel on a CUDA device in `.eval()` at fp32; otherwise the
    modules."""
    return device.type == "cuda" and not training and dtype == torch.float32


def pack_conv1d_weight(weight: torch.Tensor) -> torch.Tensor:
    """A Conv1d weight (cout, cin, k) as the kernel streams it: a flat fp32
    tensor laid out (cout / NT output-channel tiles, cin / 16 input-channel
    chunks, k taps, 2, NT * 16), each (tile, chunk, tap) the (NT, 16) block
    W_j^T[co, ci] K-major in 8-row x 16-byte core matrices (rows inside a
    core, cores along N, then along K), first its hi = `tf32_round(w)` plane
    then its lo = `tf32_round(w - hi)` plane (rounded, not left for the
    tensor cores to truncate). Copies the weight: pack once per weight
    change, not per call."""
    cout, cin, k = weight.shape
    if not conv1d_tc_takes(cin, cout, k):
        raise ValueError(f"pack_conv1d_weight: the kernel does not take a weight of shape "
                         f"{tuple(weight.shape)}")
    nt = tile_n(cout)
    with torch.no_grad():
        # W[co, ci, j] -> [co tile, ci chunk, j, co, ci]
        w = weight.detach().float().reshape(cout // nt, nt, cin // KC, KC, k)
        w = core_tiled(w.permute(0, 2, 4, 1, 3), 4)
        hi = tf32_round(w)
        return torch.stack([hi, tf32_round(w - hi)], dim=-2).reshape(-1).contiguous()


def kernel_weight(conv: nn.Conv1d) -> torch.Tensor:
    """`conv`'s weight packed for the kernel, held as its non-persistent
    buffer `kernel_weight` and packed again when the weight changed. Under
    `torch.export` the buffer is taken as it stands: pack it first
    (`VTTS.pack_kernel_weights`)."""
    if torch.compiler.is_exporting():
        packed = conv._buffers.get("kernel_weight")
        if packed is None:
            raise RuntimeError("conv1d_tc: a conv's kernel weight is not packed; pack the "
                               "model's kernel weights on its device before torch.export")
        return packed
    w = conv.weight
    key = (w.device, w.data_ptr(), w._version)
    if getattr(conv, "_kernel_weight_key", None) != key:
        conv.register_buffer("kernel_weight", pack_conv1d_weight(w), persistent=False)
        conv._kernel_weight_key = key
    return conv.kernel_weight


def conv1d_tc_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        act: str = "none", bn: Optional[Sequence[torch.Tensor]] = None,
                        eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: x (B, T, cin) against weight (cout, cin, k) as
    a channels-last implicit GEMM (each frame's k-tap window of channels,
    zero outside [0, T), times the weight flattened the same way, in fp32),
    then the kernel's epilogue. `bn`: (gamma, beta, running mean, running
    var) of an eval BatchNorm, or None."""
    B, T, cin = x.shape
    cout, _, k = weight.shape
    pad = (k - 1) // 2
    cols = F.pad(x.float(), (0, 0, pad, pad)).unfold(1, k, 1)       # (B, T, cin, k)
    v = cols.reshape(B, T, cin * k) @ weight.float().reshape(cout, cin * k).t()
    v = v + bias.float()
    if bn is not None:
        gamma, beta, mean, var = (t.float() for t in bn)
        v = (v - mean) * (1.0 / torch.sqrt(var + eps)) * gamma + beta
    if act == "relu":
        return torch.relu(v)
    if act == "tanh":
        return torch.tanh(v)
    return v


def conv1d_tc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, act: str = "none",
              bn: Optional[Sequence[torch.Tensor]] = None, eps: float = 1e-5,
              packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The conv and its epilogue on (B, T, cin), through the custom op: CPU
    tensors take `conv1d_tc_reference`; CUDA tensors launch the kernel or
    raise. `packed`: `pack_conv1d_weight(weight)`, which the kernel needs
    (packed once per weight, never here); the CPU ignores it."""
    bn = tuple(bn) if bn is not None else (None,) * 4
    tensors = (x, weight, bias, *(t for t in bn if t is not None))
    if x.device.type != "cpu":
        _checked(x, weight, bias, act, bn, packed)
        check_inference("conv1d_tc", *tensors)
    return torch.ops.votw.conv1d_tc(x, weight, bias, act, *bn, float(eps), packed)


conv1d_tc.launches = 0


def conv1d_module(x: torch.Tensor, conv: nn.Conv1d, act: str = "none",
                  bn: Optional[nn.Module] = None) -> torch.Tensor:
    """`conv` (and the eval BatchNorm `bn`) with its activation on x (B, T,
    cin) through the op, with the conv's packed weight (`kernel_weight`).
    Raises on a conv the kernel does not compute (`module_takes`)."""
    if not module_takes(conv):
        raise ValueError(f"conv1d_tc kernel does not compute {conv}: it takes a Conv1d with "
                         f"padding 'same', stride, dilation and groups 1, a bias, cin % {KC} "
                         f"== 0, cout % 128 == 0 or 80, odd k <= {KMAX}")
    stats = None if bn is None else (bn.weight, bn.bias, bn.running_mean, bn.running_var)
    return conv1d_tc(x, conv.weight, conv.bias, act, stats, bn.eps if bn is not None else 1e-5,
                     kernel_weight(conv))


def _checked(x, weight, bias, act: str, bn, packed) -> None:
    """Raise on what the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"conv1d_tc: unsupported device {x.device}")
    if x.dim() != 3 or weight.dim() != 3:
        raise ValueError(f"conv1d_tc: x (B, T, cin) and weight (cout, cin, k); got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    cout, cin, k = weight.shape
    if x.shape[2] != cin or not conv1d_tc_takes(cin, cout, k):
        raise ValueError(f"conv1d_tc kernel takes cin % {KC} == 0, cout % 128 == 0 or 80, odd "
                         f"k <= {KMAX}; got x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    if act not in ACTS:
        raise ValueError(f"conv1d_tc: activation {act!r} is not one of {tuple(ACTS)}")
    if (bn[0] is None) != any(t is None for t in bn):
        raise ValueError("conv1d_tc: a BatchNorm needs all of gamma, beta, mean and var")
    vectors = [("bias", bias)] + [(n, t) for n, t in zip(("gamma", "beta", "mean", "var"), bn)
                                  if t is not None]
    for name, t in [("x", x), ("weight", weight)] + vectors:
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"conv1d_tc kernel takes float32 on {x.device}; {name} is "
                             f"{t.dtype} on {t.device}")
    for name, t in vectors:
        if tuple(t.shape) != (cout,):
            raise ValueError(f"conv1d_tc: {name} must be ({cout},); got {tuple(t.shape)}")
    if packed is None or (packed.dtype != torch.float32 or packed.device != x.device or
                          packed.numel() != 2 * weight.numel()):
        raise ValueError(f"conv1d_tc: packed must be pack_conv1d_weight(weight) on {x.device}")


@torch.library.custom_op("votw::conv1d_tc", mutates_args=())
def _conv1d_tc_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, act: str,
                  bn_weight: Optional[torch.Tensor], bn_bias: Optional[torch.Tensor],
                  bn_mean: Optional[torch.Tensor], bn_var: Optional[torch.Tensor], eps: float,
                  packed: Optional[torch.Tensor]) -> torch.Tensor:
    raise ValueError(f"conv1d_tc: unsupported device {x.device}")


@_conv1d_tc_op.register_fake
def _(x, weight, bias, act, bn_weight, bn_bias, bn_mean, bn_var, eps, packed):
    return x.new_empty(x.shape[0], x.shape[1], weight.shape[0], dtype=torch.float32)


@_conv1d_tc_op.register_kernel("cpu")
def _(x, weight, bias, act, bn_weight, bn_bias, bn_mean, bn_var, eps, packed):
    bn = None if bn_weight is None else (bn_weight, bn_bias, bn_mean, bn_var)
    return conv1d_tc_reference(x, weight, bias, act, bn, eps)


@_conv1d_tc_op.register_kernel("cuda")
def _conv1d_tc_cuda(x, weight, bias, act, bn_weight, bn_bias, bn_mean, bn_var, eps, packed):
    """The kernel's launch, with every check it needs."""
    bn = (bn_weight, bn_bias, bn_mean, bn_var)
    _checked(x, weight, bias, act, bn, packed)
    B, T, cin = x.shape
    cout, _, k = weight.shape
    x = x.contiguous()
    if x.data_ptr() % 16:           # the kernel copies 16-byte chunks
        x = x.clone()
    packed = packed.contiguous()
    vectors = [t.contiguous() if t is not None else None for t in (bias, *bn)]
    out = torch.empty(B, T, cout, dtype=torch.float32, device=x.device)
    lib = _load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv1d_tc_fwd(
            x.data_ptr(), out.data_ptr(), packed.data_ptr(),
            *(None if t is None else t.data_ptr() for t in vectors),
            float(eps), B, T, cin, cout, k, ACTS[act], stream)
    check_launch("conv1d_tc", err)
    conv1d_tc.launches += 1
    return out


def _load_library() -> ctypes.CDLL:
    # x, y, w, bias, 4 BatchNorm vectors; eps; batch, T, cin, cout, k, act; stream
    return load_library("conv1d_tc", {
        "conv1d_tc_fwd": [ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_int] * 6
        + [ctypes.c_void_p]})
