"""Plain reference of the BigVGAN generator (Lee et al., "BigVGAN: A Universal
Neural Vocoder with Large-Scale Training", arXiv:2206.04658; NVIDIA/BigVGAN,
config bigvgan_22khz_80band for the large preset) in PyTorch operations and
float32.

mel (B, T, n_mels) -> conv_pre k7 -> per stage [ConvTranspose1d(stride u,
padding (k - u) / 2), no activation before it -> AMP: the mean over the
kernel sizes of AMPBlock1 (per dilation: x + conv1(A(conv d(A(x)))))] ->
A -> conv_post k7 -> tanh, where every activation A is anti-aliased
snake-beta: a 2x upsampler (replicate pad of 5, a stride-2 transposed conv
with the 12-tap Kaiser-windowed sinc at cutoff 0.25 and half-width 0.3,
gain 2, cropped to 2T), snake-beta x + sin^2(e^alpha x) / (e^beta + 1e-9)
with one alpha and one beta per channel and site, and a 12-tap lowpass
decimator (replicate pad 5 / 6, stride 2). `q` rounds every product's
operands, the convs' and the FIRs' alike (the identity: float32; the
control: a lower precision).

Departures from the published code: weight norm is folded (a served
generator's weights); the filters are computed here in numpy, equal to the
published `kaiser_sinc_filter1d`; padding of the resamplers follows the
published `UpSample1d` / `DownSample1d` (replicate), and the snake-beta's
parameters are stored in log scale (`snake_logscale`, as the published
config sets); the initial weights are the benchmark's (`param_specs`), not
the published N(0, 0.01).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pbcore.costs import DTYPE_BYTES, conv_flops

AA_KERNEL = 12


def kaiser_sinc(cutoff: float = 0.25, half_width: float = 0.3,
                kernel_size: int = AA_KERNEL) -> np.ndarray:
    """The published lowpass FIR (a Kaiser-windowed sinc, unit DC gain)."""
    delta_f = 4.0 * half_width
    a = 2.285 * (kernel_size - 1) * np.pi * delta_f + 7.95
    beta = 0.1102 * (a - 8.7) if a > 50.0 else \
        (0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0) if a >= 21.0 else 0.0)
    time = np.arange(-kernel_size // 2, kernel_size // 2) + 0.5
    f = 2.0 * cutoff * np.kaiser(kernel_size, beta) * np.sinc(2.0 * cutoff * time)
    return (f / f.sum()).astype(np.float32)


FIR = kaiser_sinc()


def sites(v: dict) -> list[str]:
    """Every activation site's name, in the generator's order."""
    n = len(v["upsample_rates"]) * len(v["resblock_kernel_sizes"])
    out = [f"resblocks.{r}.{acts}.{m}" for r in range(n)
           for m in range(len(v["resblock_dilations"][r % len(v["resblock_kernel_sizes"])]))
           for acts in ("acts1", "acts2")]
    return out + ["act_post"]


def param_specs(v: dict, init: dict) -> list[tuple]:
    """(name, shape, kind, value) as the serving generator names them: every
    conv and transposed conv N(0, gain^2 / fan-in) (fan-in: input channels x
    taps, over the stride for a transposed conv) with `conv_gain` /
    `up_gain`, conv_post with `post_gain`, biases 0, and every site's
    log_alpha and log_beta U(-log_scale, log_scale)."""
    ch = v["upsample_initial_channel"]

    def conv(name, c_out, c_in, k, gain, stride=1, transposed=False):
        shape = (c_in, c_out, k) if transposed else (c_out, c_in, k)
        return [(f"{name}.weight", shape, "normal", gain / (c_in * k / stride) ** 0.5),
                (f"{name}.bias", (c_out,), "const", 0.0)]

    specs = conv("conv_pre", ch, v["n_mels"], 7, init["conv_gain"])
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        specs += conv(f"ups.{i}", ch // 2 ** (i + 1), ch // 2 ** i, k, init["up_gain"], u, True)
    j = 0
    for i in range(len(v["upsample_rates"])):
        c = ch // 2 ** (i + 1)
        for k, ds in zip(v["resblock_kernel_sizes"], v["resblock_dilations"]):
            for convs in ("convs1", "convs2"):
                for m in range(len(ds)):
                    specs += conv(f"resblocks.{j}.{convs}.{m}", c, c, k, init["conv_gain"])
            j += 1
    for name in sites(v):
        c = ch // 2 ** len(v["upsample_rates"]) if name == "act_post" else \
            ch // 2 ** (int(name.split(".")[1]) // len(v["resblock_kernel_sizes"]) + 1)
        specs += [(f"{name}.log_alpha", (c,), "uniform", init["log_scale"]),
                  (f"{name}.log_beta", (c,), "uniform", init["log_scale"])]
    c = ch // 2 ** len(v["upsample_rates"])
    specs += conv("conv_post", 1, c, 7, init["post_gain"])
    return specs


def activation(p: dict, name: str, x: torch.Tensor, q) -> torch.Tensor:
    """One anti-aliased snake-beta site on x (B, C, T)."""
    c, t = x.shape[1], x.shape[2]
    fir = torch.from_numpy(FIR).to(x.device).view(1, 1, -1).repeat(c, 1, 1)
    pad = AA_KERNEL // 2 - 1
    up = F.conv_transpose1d(q(F.pad(x, (pad, pad), mode="replicate")), q(2.0 * fir), stride=2,
                            groups=c)
    lo = 2 * pad + (AA_KERNEL - 2) // 2
    u = up[:, :, lo:lo + 2 * t]
    a = torch.exp(p[f"{name}.log_alpha"]).reshape(-1, 1)
    b = torch.exp(p[f"{name}.log_beta"]).reshape(-1, 1)
    v = u + torch.sin(a * u) ** 2 / (b + 1e-9)
    vp = F.pad(v, (AA_KERNEL // 2 - 1, AA_KERNEL // 2), mode="replicate")
    return F.conv1d(q(vp), q(fir), stride=2, groups=c)


def generate(p: dict, v: dict, mel: torch.Tensor, q=lambda t: t) -> torch.Tensor:
    """(B, T, n_mels) -> (B, T * prod(upsample_rates)) float32."""
    def conv(x, name, **kw):
        return F.conv1d(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"], **kw)

    x = conv(mel.transpose(1, 2), "conv_pre", padding=3)
    n = len(v["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(q(x), q(p[f"ups.{i}.weight"]), p[f"ups.{i}.bias"], stride=u,
                               padding=(k - u) // 2)
        acc = 0.0
        for b, (rk, ds) in enumerate(zip(v["resblock_kernel_sizes"], v["resblock_dilations"])):
            name, y = f"resblocks.{i * n + b}", x
            for m, d in enumerate(ds):
                h = conv(activation(p, f"{name}.acts1.{m}", y, q), f"{name}.convs1.{m}",
                         padding=d * (rk - 1) // 2, dilation=d)
                y = y + conv(activation(p, f"{name}.acts2.{m}", h, q), f"{name}.convs2.{m}",
                             padding=(rk - 1) // 2)
            acc = acc + y
        x = acc / n
    return torch.tanh(conv(activation(p, "act_post", x, q), "conv_post", padding=3))[:, 0, :]


def site_flops(channels: int, frames: int) -> float:
    """One anti-aliased site's FIR multiply-adds: 12 taps an input sample up
    (the transposed conv), 12 an output sample down."""
    return 2.0 * 2 * AA_KERNEL * channels * frames


def amp_stage_cost(batch: int, channels: int, frames: int, dtype: str,
                   kernel_sizes=(3, 7, 11), dilations=((1, 3, 5),) * 3) -> tuple[float, float]:
    """(FLOPs, bytes) of one AMP stage: every branch's two convs per
    dilation (2 k C^2 multiply-adds a frame each) and its two sites' FIR
    taps per dilation; x read and the output written in the stage's dtype,
    the weights read once in it, the fp32 biases, log_alpha and log_beta
    once."""
    s = DTYPE_BYTES[dtype]
    taps = sum(2 * len(ds) * k for k, ds in zip(kernel_sizes, dilations))
    n_sites = sum(2 * len(ds) for ds in dilations)
    flops = batch * (2.0 * taps * channels * channels * frames +
                     n_sites * site_flops(channels, frames))
    weights = taps * channels * channels * s + 3 * n_sites * channels * 4
    return flops, 2.0 * batch * channels * frames * s + weights


def flops(v: dict, frames: int) -> list[tuple[float, str]]:
    """FLOPs for `frames` mel frames as (FLOPs, dtype) parts: conv_pre, the
    transposed convs, the AMP stages and act_post's FIRs in the vocoder's
    dtype, conv_post in fp32."""
    ch = v["upsample_initial_channel"]
    trunk = conv_flops(frames, v["n_mels"], ch, 7)
    t = frames
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        trunk += conv_flops(t, c_in, c_out, k)
        t *= u
        trunk += amp_stage_cost(1, c_out, t, "float32", v["resblock_kernel_sizes"],
                                v["resblock_dilations"])[0]
    c_last = ch // 2 ** len(v["upsample_rates"])
    trunk += site_flops(c_last, t)
    return [(trunk, v["dtype"]), (conv_flops(t, c_last, 1, 7), "float32")]
