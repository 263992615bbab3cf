"""Plain reference of the HiFi-GAN V1 generator (jik876/hifi-gan,
config_v1.json; arXiv:2010.05646) in PyTorch operations and float32.

mel (B, T, n_mels) -> conv_pre k7 -> per stage [leaky ReLU 0.1 ->
ConvTranspose1d(stride u, padding (k - u) / 2) -> MRF: the mean over the
kernel sizes of ResBlock1 (per dilation: x + conv1(lrelu(conv d(lrelu(x)))))]
-> leaky ReLU 0.01 -> conv_post k7 -> tanh. `q` rounds every product's
operands (the identity: float32; the control: a lower precision).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from pbcore.costs import conv_flops, mrf_stage_cost


def param_specs(v: dict, init: dict) -> list[tuple]:
    """(name, shape, kind, value) as the serving generator names them: every
    conv N(0, conv_std) (the reference's init), conv_post N(0, conv_post_std),
    biases 0."""
    ch, std = v["upsample_initial_channel"], init["conv_std"]
    specs = [("conv_pre.weight", (ch, v["n_mels"], 7), "normal", std)]
    specs.append(("conv_pre.bias", (ch,), "const", 0.0))
    for i, k in enumerate(v["upsample_kernel_sizes"]):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        specs += [(f"ups.{i}.weight", (c_in, c_out, k), "normal", std),
                  (f"ups.{i}.bias", (c_out,), "const", 0.0)]
    j = 0
    for i in range(len(v["upsample_rates"])):
        c = ch // 2 ** (i + 1)
        for k, ds in zip(v["resblock_kernel_sizes"], v["resblock_dilations"]):
            for conv in ("convs1", "convs2"):
                for m in range(len(ds)):
                    specs += [(f"resblocks.{j}.{conv}.{m}.weight", (c, c, k), "normal", std),
                              (f"resblocks.{j}.{conv}.{m}.bias", (c,), "const", 0.0)]
            j += 1
    c = ch // 2 ** len(v["upsample_rates"])
    specs += [("conv_post.weight", (1, c, 7), "normal", init["conv_post_std"]),
              ("conv_post.bias", (1,), "const", 0.0)]
    return specs


def generate(p: dict, v: dict, mel: torch.Tensor, q=lambda t: t) -> torch.Tensor:
    """(B, T, n_mels) -> (B, T * prod(upsample_rates)) float32."""
    def conv(x, name, **kw):
        return F.conv1d(q(x), q(p[f"{name}.weight"]), p[f"{name}.bias"], **kw)

    x = conv(mel.transpose(1, 2), "conv_pre", padding=3)
    n = len(v["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        x = F.conv_transpose1d(q(F.leaky_relu(x, 0.1)), q(p[f"ups.{i}.weight"]),
                               p[f"ups.{i}.bias"], stride=u, padding=(k - u) // 2)
        acc = 0.0
        for b, (rk, ds) in enumerate(zip(v["resblock_kernel_sizes"], v["resblock_dilations"])):
            name, y = f"resblocks.{i * n + b}", x
            for m, d in enumerate(ds):
                h = conv(F.leaky_relu(y, 0.1), f"{name}.convs1.{m}", padding=d * (rk - 1) // 2,
                         dilation=d)
                y = y + conv(F.leaky_relu(h, 0.1), f"{name}.convs2.{m}", padding=(rk - 1) // 2)
            acc = acc + y
        x = acc / n
    return torch.tanh(conv(F.leaky_relu(x, 0.01), "conv_post", padding=3))[:, 0, :]


def flops(v: dict, frames: int) -> list[tuple[float, str]]:
    """FLOPs for `frames` mel frames as (FLOPs, dtype) parts: conv_pre, the
    transposed convs and the MRF stages in the vocoder's dtype, conv_post in
    fp32."""
    ch = v["upsample_initial_channel"]
    trunk = conv_flops(frames, v["n_mels"], ch, 7)
    t = frames
    for i, (u, k) in enumerate(zip(v["upsample_rates"], v["upsample_kernel_sizes"])):
        c_in, c_out = ch // 2 ** i, ch // 2 ** (i + 1)
        trunk += conv_flops(t, c_in, c_out, k)
        t *= u
        trunk += mrf_stage_cost(1, c_out, t, "float32", v["resblock_kernel_sizes"],
                                v["resblock_dilations"])[0]
    post = conv_flops(t, ch // 2 ** len(v["upsample_rates"]), 1, 7)
    return [(trunk, v["dtype"]), (post, "float32")]
