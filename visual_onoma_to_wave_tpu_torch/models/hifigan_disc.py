"""HiFi-GAN discriminators (MPD, MSD, MRD) and the GAN losses (port of
visual_onoma_to_wave_tpu/models/hifigan_disc.py).

* Multi-Period Discriminator: one sub-discriminator per period (2, 3, 5, 7,
  11) over a (T/p, p) view of the waveform, reflect-padded to a period
  multiple: Conv2d (5, 1) stride (3, 1) stacks, channels 32 -> 1024.
* Multi-Scale Discriminator: grouped Conv1d stacks on the raw audio and
  on 2x and 4x average-pooled audio (`AvgPool1d(4, 2, 2)`, pads counted).
* Multi-Resolution Discriminator (UnivNet, the BigVGAN recipe's partner of
  the MPD): 2-D conv stacks over eps-guarded STFT magnitudes at three
  resolutions.
* LSGAN adversarial losses, feature matching L1 (x2).

Every convolution is `WNConv`: trainable weight normalisation with the
reference's formula, w = g * v / sqrt(sum v^2 + 1e-12) per output filter,
g initialised to sqrt(1/3) and v as torch's conv default. Parameters keep
the reference's names: `v`, `g`, `b` in each conv, sub-discriminators
`p2`...`p11`, `s0`...`s2` and `r1024` / `r2048` / `r512`, and each
sub-discriminator's i-th conv (the reference's `WNConv_i`) is `convs.i`;
`v` is stored in torch's conv layout (out, in / groups, *kernel), and the
bridge (`bridge.mpd_state_dict`, ...) maps the reference's HWIO kernels onto
it.
The convolutions run in torch's channels-first layout: a feature map is
the reference's NHWC / NHC map transposed, and each logits tensor is the
reference's, element for element. These modules run no hand-written
kernel. `dtype` is the compute dtype (JAX hifigan_disc.py:43-81): in
bfloat16 each conv runs in bf16 on its input and weight cast down (the
weight-norm math stays fp32), its output rounded once and its bias added in
bf16; feature maps are bf16 and the logits fp32. The MRD's STFT magnitude
is fp32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from visual_onoma_to_wave_tpu_torch.ops.stft import frame_signal, hann_window, reflect_pad
from visual_onoma_to_wave_tpu_torch.precision import in_dtype, leaky_relu

LRELU_SLOPE = 0.1


class WNConv(nn.Module):
    """Conv1d (1-D kernel) or Conv2d (2-D kernel) with trainable weight
    normalisation; channels-first input."""

    def __init__(self, in_channels: int, features: int, kernel_size, stride=None,
                 padding=None, groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        k = tuple(kernel_size)
        self.stride = tuple(stride or (1,) * len(k))
        self.padding = tuple(padding or (0,) * len(k))   # symmetric, per spatial axis
        self.groups = groups
        self.v = nn.Parameter(torch.empty(features, in_channels // groups, *k))
        # torch's conv default: U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the
        # reference's variance_scaling(1/3, fan_in, uniform)
        nn.init.kaiming_uniform_(self.v, a=math.sqrt(5))
        self.g = nn.Parameter(torch.full((features,), float(np.sqrt(1 / 3)), dtype=torch.float32))
        self.b = nn.Parameter(torch.zeros(features))

    def weight(self) -> torch.Tensor:
        dims = tuple(range(1, self.v.ndim))
        norm = torch.sqrt(torch.sum(self.v * self.v, dim=dims, keepdim=True) + 1e-12)
        shape = (-1,) + (1,) * (self.v.ndim - 1)
        return (self.g.reshape(shape) / norm) * self.v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = F.conv1d if self.v.ndim == 3 else F.conv2d
        return in_dtype(conv, x, self.weight(), self.b, self.dtype, stride=self.stride,
                        padding=self.padding, groups=self.groups)


def _stack(convs, h: torch.Tensor):
    """Every conv but the last followed by leaky ReLU 0.1, each output a
    feature map, the last conv's output the logits: (logits (B, N) fp32,
    maps in the compute dtype)."""
    fmaps = []
    for conv in convs[:-1]:
        h = leaky_relu(conv(h), LRELU_SLOPE)
        fmaps.append(h)
    h = convs[-1](h)
    fmaps.append(h)
    return h.reshape(h.shape[0], -1).float(), fmaps


class PeriodDiscriminator(nn.Module):
    """One MPD sub-discriminator over a (T/p, p) view of the waveform."""

    def __init__(self, period: int, channels=(32, 128, 512, 1024),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.period = period
        chans = (1,) + tuple(channels)
        self.convs = nn.ModuleList(
            [WNConv(chans[i], chans[i + 1], (5, 1), (3, 1), (2, 0), dtype=dtype)
             for i in range(len(channels))]
            + [WNConv(chans[-1], chans[-1], (5, 1), (1, 1), (2, 0), dtype=dtype),
               WNConv(chans[-1], 1, (3, 1), (1, 1), (1, 0), dtype=dtype)])

    def forward(self, x: torch.Tensor):
        """x: (B, T) -> (logits (B, N), feature maps (B, C, T/p, p))."""
        b, t = x.shape
        p = self.period
        pad = (-t) % p
        if pad:   # reflect-pad to a period multiple (the official F.pad mode)
            x = F.pad(x[:, None], (0, pad), mode="reflect")[:, 0]
        return _stack(self.convs, x.reshape(b, 1, -1, p))


# (out channels as a multiple of `channels`, kernel, stride, groups, pad):
# the official layer plan at channels 128
_SCALE_LAYERS = ((1, 15, 1, 1, 7), (1, 41, 2, 4, 20), (2, 41, 2, 16, 20), (4, 41, 4, 16, 20),
                 (8, 41, 4, 16, 20), (8, 41, 1, 16, 20), (8, 5, 1, 1, 2))


class ScaleDiscriminator(nn.Module):
    """One MSD sub-discriminator: a grouped Conv1d stack on raw audio."""

    def __init__(self, channels: int = 128, dtype: torch.dtype = torch.float32):
        super().__init__()
        convs, cin = [], 1
        for mult, k, s, g, pad in _SCALE_LAYERS:
            ch = mult * channels
            # the official group counts at channels 128; gcd keeps narrow
            # widths valid while preserving them at full size
            groups = math.gcd(math.gcd(g, cin), ch)
            convs.append(WNConv(cin, ch, (k,), (s,), (pad,), groups, dtype))
            cin = ch
        self.convs = nn.ModuleList(convs + [WNConv(cin, 1, (3,), (1,), (1,), dtype=dtype)])

    def forward(self, x: torch.Tensor):
        """x: (B, T) -> (logits (B, N), feature maps (B, C, T'))."""
        return _stack(self.convs, x[:, None])


def avg_pool1d(x: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, T // 2 + 1): torch `AvgPool1d(4, 2, padding=2)`, the
    pads counted in each mean, as the reference's `_avg_pool1d`."""
    return F.avg_pool1d(x[:, None], 4, 2, padding=2, count_include_pad=True)[:, 0]


class _Pair(nn.Module):
    """Scores real and generated audio with the same sub-discriminators:
    (y, y_hat) -> (real logits, generated logits, real feature maps,
    generated feature maps), each a list over the sub-discriminators. When
    neither input needs a gradient (the discriminators' own update, on the
    detached waveform) the two go through each sub-discriminator as one
    batch of 2B: the same losses, 7-10% less time a GAN step on the card
    (`tools/gan_step_ab_torch.py`, PERF.md section 6)."""

    def score(self, subs, ys, y_hats):
        rs, gs, fr, fg = [], [], [], []
        for d, y, y_hat in zip(subs, ys, y_hats):
            if y.requires_grad or y_hat.requires_grad:
                lr, mr = d(y)
                lg, mg = d(y_hat)
            else:
                b = y.shape[0]
                logits, maps = d(torch.cat([y, y_hat]))
                lr, lg = logits[:b], logits[b:]
                mr, mg = [m[:b] for m in maps], [m[b:] for m in maps]
            rs.append(lr), gs.append(lg), fr.append(mr), fg.append(mg)
        return rs, gs, fr, fg


class MultiPeriodDiscriminator(_Pair):
    def __init__(self, periods=(2, 3, 5, 7, 11), channels=(32, 128, 512, 1024),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.periods = tuple(periods)
        for p in self.periods:
            self.add_module(f"p{p}", PeriodDiscriminator(p, channels, dtype))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        subs = [getattr(self, f"p{p}") for p in self.periods]
        return self.score(subs, [y] * len(subs), [y_hat] * len(subs))


class MultiScaleDiscriminator(_Pair):
    def __init__(self, n_scales: int = 3, channels: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.n_scales = n_scales
        for s in range(n_scales):
            self.add_module(f"s{s}", ScaleDiscriminator(channels, dtype))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        ys, y_hats = [y], [y_hat]
        for _ in range(self.n_scales - 1):
            ys.append(avg_pool1d(ys[-1]))
            y_hats.append(avg_pool1d(y_hats[-1]))
        return self.score([getattr(self, f"s{s}") for s in range(self.n_scales)], ys, y_hats)


class ResolutionDiscriminator(nn.Module):
    """One MRD sub-discriminator: a 2-D conv stack over an STFT magnitude,
    (B, 1, freq bins, frames); kernels (3, 9) span 3 bins x 9 frames,
    strides (1, 2) decimate time."""

    def __init__(self, resolution=(1024, 120, 600), channels: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resolution = tuple(int(r) for r in resolution)
        n_fft, _, win = self.resolution
        window = torch.from_numpy(hann_window(win))
        if win < n_fft:      # centre-padded to n_fft
            lpad = (n_fft - win) // 2
            window = F.pad(window, (lpad, n_fft - win - lpad))
        self.register_buffer("window", window, persistent=False)
        self.convs = nn.ModuleList(
            [WNConv(1 if i == 0 else channels, channels, (3, 9), s, (1, 4), dtype=dtype)
             for i, s in enumerate(((1, 1), (1, 2), (1, 2), (1, 2)))]
            + [WNConv(channels, channels, (3, 3), (1, 1), (1, 1), dtype=dtype),
               WNConv(channels, 1, (3, 3), (1, 1), (1, 1), dtype=dtype)])

    def magnitude(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, T', F): sqrt(re^2 + im^2 + 1e-9), so that the exactly
        zero bins of zero-padded segments keep finite gradients."""
        n_fft, hop, _ = self.resolution
        frames = frame_signal(reflect_pad(x.float(), n_fft // 2), n_fft, hop)
        spec = torch.fft.rfft(frames * self.window, n=n_fft, dim=-1)
        return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)

    def forward(self, x: torch.Tensor):
        """x: (B, T) -> (logits (B, N), feature maps (B, C, F, T''))."""
        return _stack(self.convs, self.magnitude(x).transpose(1, 2)[:, None])


class MultiResolutionDiscriminator(_Pair):
    """The MSD's interface over STFT resolutions (n_fft, hop, win): the
    UnivNet / BigVGAN triple by default."""

    def __init__(self, resolutions=((1024, 120, 600), (2048, 240, 1200), (512, 50, 240)),
                 channels: int = 32, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.resolutions = tuple(tuple(int(v) for v in r) for r in resolutions)
        for r in self.resolutions:
            self.add_module(f"r{r[0]}", ResolutionDiscriminator(r, channels, dtype))

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        subs = [getattr(self, f"r{r[0]}") for r in self.resolutions]
        return self.score(subs, [y] * len(subs), [y_hat] * len(subs))


# ---------------------------------------------------------------------------
# GAN losses (HiFi-GAN eqs. 1-3, LSGAN form)
# ---------------------------------------------------------------------------

def discriminator_loss(real_logits, gen_logits) -> torch.Tensor:
    """sum_k E[(1 - D_k(y))^2] + E[D_k(y_hat)^2]."""
    loss = 0.0
    for dr, dg in zip(real_logits, gen_logits):
        loss = loss + torch.mean((1.0 - dr.float()) ** 2) + torch.mean(dg.float() ** 2)
    return loss


def generator_adversarial_loss(gen_logits) -> torch.Tensor:
    """sum_k E[(1 - D_k(y_hat))^2]."""
    loss = 0.0
    for dg in gen_logits:
        loss = loss + torch.mean((1.0 - dg.float()) ** 2)
    return loss


def feature_matching_loss(real_fmaps, gen_fmaps) -> torch.Tensor:
    """2 x the sum over sub-discriminators and layers of L1(fm_r, fm_g)."""
    loss = 0.0
    for mr, mg in zip(real_fmaps, gen_fmaps):
        for r, g in zip(mr, mg):
            loss = loss + torch.mean(torch.abs(r.float() - g.float()))
    return 2.0 * loss
