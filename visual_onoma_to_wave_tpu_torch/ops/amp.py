"""BigVGAN's anti-aliased snake-beta activation: CUDA kernel + plain PyTorch version.

One activation site of an AMP block (Lee et al., arXiv:2206.04658) on x
(B, C, T): a 2x Kaiser-sinc upsampler (12 taps, replicate padding), snake-
beta at twice the rate, and a 12-tap lowpass decimator (replicate padding):

    u = upsample2(x);   v = u + sin^2(a u) / (b + 1e-9);   out = downsample2(v)

with a = exp(log_alpha), b = exp(log_beta) per channel. The filters
(`kaiser_sinc_filter1d`, `UP_FILTER`, `DOWN_FILTER`) and the resamplers
(`upsample2`, `downsample2`) are the ones `models/bigvgan.py` builds its
modules from.

The kernel (`csrc/amp.cu`, built at first use by `ops/cuda_build.py`) runs a
site in one pass: it reads the operand once, keeps the 2x signal on chip in
fp32 and writes the activated operand once, rounded to the operand's type
(fp32 or bf16). Its operand may be a sum, round(x + g + bias), which it can
also write (a residual stream's update), and it can write the mean of three
branches' streams. `amp_launch` is that launch; `ops/mrf.py`'s AMP stage
calls it directly; `amp_act` is one site through the custom op
`votw::amp_act` (CPU implementation `amp_act_reference`, CUDA the kernel,
fake the shape), for the site outside the stages (BigVGAN's `act_post`).
`amp_act.launches` counts the kernel's launches, every site and every mode.

`amp_act_reference` is the kernel's arithmetic in PyTorch ops: the operand
rounded to its type, every step after it in fp32 (the resamplers with fp32
taps), the output rounded once. It is what the CPU runs and what the tests
hold the kernel to; the bf16 modules of `models/bigvgan.py` round after each
op instead.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from visual_onoma_to_wave_tpu_torch.ops.cuda_build import (
    check_inference,
    check_launch,
    load_library,
)

AA_KERNEL = 12  # K = int(6 * ratio / 2) * 2 at ratio 2
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Lowpass FIR: a windowed sinc with the Kaiser beta chosen from the
    stopband attenuation this size and transition width allow; cutoff and
    half_width in cycles per sample (Nyquist 0.5); unit DC gain."""
    delta_f = 4.0 * half_width
    a = 2.285 * (kernel_size - 1) * np.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if kernel_size % 2 == 0:
        time = np.arange(-kernel_size // 2, kernel_size // 2) + 0.5
    else:
        time = np.arange(kernel_size) - (kernel_size - 1) / 2
    f = 2.0 * cutoff * window * np.sinc(2.0 * cutoff * time)
    f /= f.sum()
    return f.astype(np.float32)


# the resamplers' filters: interpolation (gain 2) and lowpass
UP_FILTER = 2.0 * kaiser_sinc_filter1d(0.25, 0.3, AA_KERNEL)
DOWN_FILTER = kaiser_sinc_filter1d(0.25, 0.3, AA_KERNEL)


def depthwise_filter(h: np.ndarray, channels: int) -> torch.Tensor:
    """(channels, 1, K) contiguous: one FIR `h` for every channel."""
    return torch.from_numpy(np.array(h, np.float32)).view(1, 1, -1).repeat(channels, 1, 1)


def upsample2(x: torch.Tensor, w_up: torch.Tensor) -> torch.Tensor:
    """(B, C, T) -> (B, C, 2T): edge pad of K/2 - 1, a stride-2 depthwise
    transposed conv with the gain-2 interpolation filter `w_up` (C, 1, K),
    then the centre crop to 2T. The filter is symmetric, so the transposed
    conv equals the reference's lhs-dilated correlation without a flip."""
    c, t = x.shape[1], x.shape[2]
    pad = AA_KERNEL // 2 - 1
    y = F.conv_transpose1d(F.pad(x, (pad, pad), mode="replicate"), w_up.to(x.dtype), stride=2,
                           groups=c)
    lo = 2 * pad + (AA_KERNEL - 2) // 2
    return y[:, :, lo:lo + 2 * t]


def downsample2(x: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """(B, C, 2T) -> (B, C, T): edge pad (K/2 - 1, K/2), then a stride-2
    depthwise conv with the lowpass filter `w_down` (C, 1, K)."""
    xp = F.pad(x, (AA_KERNEL // 2 - 1, AA_KERNEL // 2), mode="replicate")
    return F.conv1d(xp, w_down.to(x.dtype), stride=2, groups=x.shape[1])


def amp_operand(x: torch.Tensor, g: torch.Tensor | None = None,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel's operand: x, or round(x + g + bias) in x's type (the sum
    in fp32, bias (C,) on the channel axis)."""
    if g is None and bias is None:
        return x
    p = x.float()
    if g is not None:
        p = p + g.float()
    if bias is not None:
        p = p + bias.float().reshape(-1, 1)
    return p.to(x.dtype)


def amp_act_reference(p: torch.Tensor, log_alpha: torch.Tensor,
                      log_beta: torch.Tensor) -> torch.Tensor:
    """One anti-aliased snake-beta site on p (B, C, T) in fp32 (fp32 taps),
    rounded once to p's type."""
    c = p.shape[1]
    u = upsample2(p.float(), depthwise_filter(UP_FILTER, c).to(p.device))
    a = torch.exp(log_alpha.float()).reshape(-1, 1)
    inv_b = 1.0 / (torch.exp(log_beta.float()).reshape(-1, 1) + 1e-9)
    v = u + torch.sin(a * u) ** 2 * inv_b
    return downsample2(v, depthwise_filter(DOWN_FILTER, c).to(p.device)).to(p.dtype)


# --------------------------------------------------------------- the kernel
_TAPS = (ctypes.c_float * (2 * AA_KERNEL))(*UP_FILTER.tolist(), *DOWN_FILTER.tolist())


def _load_library() -> ctypes.CDLL:
    # x, g, bias, y_out, a_out, m0, m1, mean_out, log_alpha, log_beta; the
    # host taps; rows, C, T, dtype; stream
    return load_library("amp", {
        "amp_act_fwd": [ctypes.c_void_p] * 10 + [ctypes.POINTER(ctypes.c_float),
                                                 ctypes.c_longlong] + [ctypes.c_int] * 3
        + [ctypes.c_void_p]})


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def amp_launch(x: torch.Tensor, log_alpha: torch.Tensor | None = None,
               log_beta: torch.Tensor | None = None, g: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, y: bool = False, act: bool = True,
               mean: tuple[torch.Tensor, torch.Tensor] | None = None):
    """One launch of the kernel on checked-here operands: x, g and the two
    `mean` streams (B, C, T) contiguous of one type (fp32 or bf16) on the
    card; bias, log_alpha, log_beta (C,) fp32 contiguous. Returns (p or None,
    the activated p or None, the mean or None), p = round(x + g + bias)
    written only with `y`, the activation only with `act`, the mean
    round((m0 + m1 + p) * (1/3)) only with `mean`."""
    if x.dim() != 3 or x.dtype not in _DTYPE_CODES or not x.is_contiguous() or \
            x.device.type != "cuda":
        raise ValueError(f"amp_act kernel takes contiguous fp32/bf16 (B, C, T) on CUDA; got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    B, C, T = x.shape
    if T == 0 or B * C == 0:
        raise ValueError(f"amp_act kernel takes a non-empty (B, C, T); got {tuple(x.shape)}")
    for name, t in (("g", g), *((f"mean[{i}]", m) for i, m in enumerate(mean or ()))):
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype or not t.is_contiguous()
                              or t.device != x.device):
            raise ValueError(f"amp_act kernel: {name} {tuple(t.shape)} {t.dtype} does not fit x "
                             f"{tuple(x.shape)} {x.dtype}")
    for name, t in (("bias", bias), ("log_alpha", log_alpha), ("log_beta", log_beta)):
        if t is not None and (t.numel() != C or t.dtype != torch.float32 or
                              not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"amp_act kernel: {name} {tuple(t.shape)} {t.dtype} does not fit "
                             f"({C},) fp32 on {x.device}")
    if act and (log_alpha is None or log_beta is None):
        raise ValueError("amp_act kernel: the activation needs log_alpha and log_beta")
    if mean is not None and len(mean) != 2:
        raise ValueError("amp_act kernel: the mean takes two more branches' streams")
    if not (y or act or mean is not None):
        raise ValueError("amp_act kernel: nothing to write")
    p_out = torch.empty_like(x) if y else None
    a_out = torch.empty_like(x) if act else None
    m_out = torch.empty_like(x) if mean is not None else None
    m0, m1 = mean if mean is not None else (None, None)
    lib = _load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.amp_act_fwd(
            x.data_ptr(), _ptr(g), _ptr(bias), _ptr(p_out), _ptr(a_out), _ptr(m0), _ptr(m1),
            _ptr(m_out), _ptr(log_alpha), _ptr(log_beta), _TAPS, B * C, C, T,
            _DTYPE_CODES[x.dtype], stream)
    check_launch("amp_act", err)
    amp_act.launches += 1
    return p_out, a_out, m_out


def amp_act(x: torch.Tensor, log_alpha: torch.Tensor, log_beta: torch.Tensor) -> torch.Tensor:
    """One anti-aliased snake-beta site on x (B, C, T) through the custom op:
    CPU tensors take `amp_act_reference`, CUDA tensors launch the kernel or
    raise (fp32 or bf16 x; the log parameters (C,))."""
    if x.device.type != "cpu":
        check_inference("amp_act", x, log_alpha, log_beta)
    return torch.ops.votw.amp_act(x, log_alpha, log_beta)


amp_act.launches = 0


@torch.library.custom_op("votw::amp_act", mutates_args=())
def _amp_act_op(x: torch.Tensor, log_alpha: torch.Tensor,
                log_beta: torch.Tensor) -> torch.Tensor:
    raise ValueError(f"amp_act: unsupported device {x.device}")


@_amp_act_op.register_fake
def _(x, log_alpha, log_beta):
    return torch.empty_like(x)


@_amp_act_op.register_kernel("cpu")
def _(x, log_alpha, log_beta):
    return amp_act_reference(x, log_alpha, log_beta)


@_amp_act_op.register_kernel("cuda")
def _(x, log_alpha, log_beta):
    return amp_launch(x.contiguous(), log_alpha.float().contiguous(),
                      log_beta.float().contiguous())[1]

