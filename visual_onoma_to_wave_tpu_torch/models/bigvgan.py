"""BigVGAN generator, inference (port of visual_onoma_to_wave_tpu/models/bigvgan.py).

Mel (B, T, n_mels) feature-last -> waveform (B, T * prod(upsample_rates)).
HiFi-GAN's skeleton (conv_pre, transposed-conv upsampling with no activation
before it, multi-receptive-field fusion averaged over the branches,
conv_post in fp32, tanh) with HiFi-GAN's ResBlock1 replaced by `AMPBlock1`:
its leaky ReLUs become snake / snake-beta activations (per-channel alpha and
beta learned in log scale), each optionally anti-aliased, i.e. run at twice
the local rate between a Kaiser-windowed-sinc upsampler and a lowpass
decimator (Lee et al., arXiv:2206.04658).

Internally (B, C, T). The anti-aliasing filters are numpy constants equal
to the reference's; each activation holds them as (C, 1, K) contiguous
buffers, so they reach the device once with the module and every
depthwise conv gets contiguous weights. BigVGAN reaches no hand-written
kernel: its convs, FIRs and snake run as PyTorch ops (cuDNN on the card),
as the reference runs them through XLA. Module names: conv_pre, ups.i,
resblocks.{i * n_kernels + j}.convs1|convs2.k, resblocks.r.acts1|acts2.k
.log_alpha|log_beta, act_post, conv_post (`bridge.bigvgan_state_dict`).

`dtype` is the compute dtype (JAX bigvgan.py:83-172): in bfloat16 the convs
and the anti-aliasing FIRs (their taps rounded to bf16) compute in bf16 with
fp32 parameters (`precision.at_dtype`), snake takes exp of its fp32 log
parameters and computes the rest in bf16, and conv_post and tanh stay fp32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from visual_onoma_to_wave_tpu_torch.models.hifigan import receptive_halo_frames
from visual_onoma_to_wave_tpu_torch.precision import at_dtype

AA_KERNEL = 12  # K = int(6 * ratio / 2) * 2 at ratio 2


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


def snake(x: torch.Tensor, log_alpha: torch.Tensor) -> torch.Tensor:
    """x + sin^2(a x) / a, a = exp(log_alpha) per channel; x (B, C, T)."""
    a = torch.exp(log_alpha.float()).to(x.dtype)[:, None]
    return x + torch.sin(a * x) ** 2 / (a + 1e-9)


def snake_beta(x: torch.Tensor, log_alpha: torch.Tensor, log_beta: torch.Tensor) -> torch.Tensor:
    """x + sin^2(a x) / b: frequency a = exp(log_alpha), magnitude
    b = exp(log_beta), per channel; x (B, C, T)."""
    a = torch.exp(log_alpha.float()).to(x.dtype)[:, None]
    b = torch.exp(log_beta.float()).to(x.dtype)[:, None]
    return x + torch.sin(a * x) ** 2 / (b + 1e-9)


class SnakeAct(nn.Module):
    """One activation site: snake or snake-beta, optionally between the 2x
    resamplers (whose filters are non-persistent buffers), in `dtype`."""

    def __init__(self, channels: int, activation: str = "snakebeta", anti_aliased: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        if activation not in ("snake", "snakebeta"):
            raise ValueError(f"unknown activation {activation!r}")
        self.log_alpha = nn.Parameter(torch.zeros(channels))
        self.log_beta = nn.Parameter(torch.zeros(channels)) if activation == "snakebeta" else None
        self.anti_aliased = anti_aliased
        if anti_aliased:
            self.register_buffer("w_up", depthwise_filter(UP_FILTER, channels), persistent=False)
            self.register_buffer("w_down", depthwise_filter(DOWN_FILTER, channels),
                                 persistent=False)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        if self.log_beta is None:
            return snake(x, self.log_alpha)
        return snake_beta(x, self.log_alpha, self.log_beta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.anti_aliased:
            return self.act(x)
        return downsample2(self.act(upsample2(x, self.w_up)), self.w_down)


def _conv(c: int, k: int, d: int) -> nn.Conv1d:
    return nn.Conv1d(c, c, k, dilation=d, padding=d * (k - 1) // 2)


class AMPBlock1(nn.Module):
    """HiFi-GAN's ResBlock1 with snake activations: for each dilation d,
    x += conv2(act2(conv1_d(act1(x))))."""

    def __init__(self, channels: int, kernel_size: int, dilations=(1, 3, 5),
                 activation: str = "snakebeta", anti_aliased: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convs1 = nn.ModuleList(_conv(channels, kernel_size, d) for d in dilations)
        self.convs2 = nn.ModuleList(_conv(channels, kernel_size, 1) for _ in dilations)
        self.acts1 = nn.ModuleList(SnakeAct(channels, activation, anti_aliased, dtype)
                                   for _ in dilations)
        self.acts2 = nn.ModuleList(SnakeAct(channels, activation, anti_aliased, dtype)
                                   for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, self.acts1, self.acts2):
            h = a2(at_dtype(c1, a1(x), self.dtype))
            x = x + at_dtype(c2, h, self.dtype)
        return x


# model-size presets: base = bigvgan_base_22khz_80band (HiFi-GAN V1's upsample
# plan), large = bigvgan_22khz_80band (1536 channels, rates 4, 4, 2, 2, 2, 2)
BIGVGAN_PRESETS = {
    "base": {},
    "large": {
        "upsample_rates": (4, 4, 2, 2, 2, 2),
        "upsample_kernel_sizes": (8, 8, 4, 4, 4, 4),
        "upsample_initial_channel": 1536,
    },
}


class BigVGANGenerator(nn.Module):
    def __init__(self, upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                 upsample_initial_channel: int = 512, resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilations=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 activation: str = "snakebeta", anti_aliased: bool = True, n_mels: int = 80,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.upsample_initial_channel = upsample_initial_channel
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilations = tuple(tuple(d) for d in resblock_dilations)
        self.activation = activation
        self.anti_aliased = anti_aliased
        ch0 = upsample_initial_channel
        self.num_kernels = len(resblock_kernel_sizes)
        self.conv_pre = nn.Conv1d(n_mels, ch0, 7, padding=3)
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(ch0 // 2 ** i, ch0 // 2 ** (i + 1), k, stride=u,
                               padding=(k - u) // 2)
            for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)))
        self.resblocks = nn.ModuleList(
            AMPBlock1(ch0 // 2 ** (i + 1), rk, tuple(rd), activation, anti_aliased, dtype)
            for i in range(len(upsample_rates))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilations))
        ch_last = ch0 // 2 ** len(upsample_rates)
        self.act_post = SnakeAct(ch_last, activation, anti_aliased, dtype)
        self.conv_post = nn.Conv1d(ch_last, 1, 7, padding=3)
        # the reference's initial distributions: weights N(0, 0.01), biases
        # and log-alpha / log-beta 0
        for name, p in self.named_parameters():
            if name.endswith(".weight"):
                nn.init.normal_(p, std=0.01)
            else:
                nn.init.zeros_(p)

    @property
    def total_upsample(self) -> int:
        return int(np.prod(self.upsample_rates, dtype=np.int64))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = at_dtype(self.conv_pre, mel.transpose(1, 2), self.dtype)
        n = self.num_kernels
        for i, up in enumerate(self.ups):
            x = at_dtype(up, x, self.dtype)
            acc = None
            for block in self.resblocks[i * n:(i + 1) * n]:
                y = block(x)
                acc = y if acc is None else acc + y
            x = acc / n
        x = self.conv_post(self.act_post(x).float())
        return torch.tanh(x)[:, 0, :]

    def receptive_halo_frames(self) -> int:
        """One-sided receptive field in input mel frames (chunked vocoding,
        `hifigan.vocoder_infer_chunked`): HiFi-GAN's derivation plus, per
        anti-aliased activation, 2 K - 2 samples at its own rate (the
        reference's count, which may only over-cover)."""
        return receptive_halo_frames(
            self.upsample_rates, self.upsample_kernel_sizes, self.resblock_kernel_sizes,
            self.resblock_dilations, aa_span=(2 * AA_KERNEL - 2) if self.anti_aliased else 0)
