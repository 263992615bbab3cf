"""Plain reference of the mel-Vocos generator (arXiv:2306.00814: dim 512,
intermediate 1536, 8 ConvNeXt blocks, layer scale 1/8, n_fft 1024, hop 256)
in PyTorch operations and float32, with the serving port's head.

mel (B, T, n_mels) -> embed conv k7 -> LayerNorm -> blocks [depthwise conv
k7 -> LayerNorm -> Linear -> GELU -> Linear -> x + gamma * .] -> LayerNorm
-> Linear to log-magnitude and phase -> mag = exp(min(logmag, ln 100)) ->
inverse real FFT of each frame, periodic Hann window, overlap-add at hop
n_fft / 4, the (n_fft - hop) / 2 edge trimmed, divided by the window's
summed square (floor 1e-8). `q` rounds every product's operands.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from pbcore.costs import conv_flops, convnext_block_cost


def param_specs(v: dict, init: dict) -> list[tuple]:
    """(name, shape, kind, value) as the serving generator names them:
    matrices N(0, 0.02), biases 0, norms 1 and 0, layer scale 1 / layers."""
    dim, inner, std = v["dim"], v["intermediate_dim"], init["weight_std"]
    n_bins = v["istft_n_fft"] // 2 + 1
    specs = [("embed_w", (7, v["n_mels"], dim), "normal", std), ("embed_b", (dim,), "const", 0.0),
             ("norm_in_scale", (dim,), "const", 1.0), ("norm_in_bias", (dim,), "const", 0.0)]
    for i in range(v["num_layers"]):
        b = f"blocks.{i}"
        specs += [(f"{b}.dwconv_w", (7, 1, dim), "normal", std),
                  (f"{b}.dwconv_b", (dim,), "const", 0.0),
                  (f"{b}.norm_scale", (dim,), "const", 1.0),
                  (f"{b}.norm_bias", (dim,), "const", 0.0),
                  (f"{b}.pw1_w", (dim, inner), "normal", std),
                  (f"{b}.pw1_b", (inner,), "const", 0.0),
                  (f"{b}.pw2_w", (inner, dim), "normal", std),
                  (f"{b}.pw2_b", (dim,), "const", 0.0),
                  (f"{b}.gamma", (dim,), "const", 1.0 / v["num_layers"])]
    specs += [("norm_out_scale", (dim,), "const", 1.0), ("norm_out_bias", (dim,), "const", 0.0),
              ("head_w", (dim, 2 * n_bins), "normal", std),
              ("head_b", (2 * n_bins,), "const", 0.0)]
    return specs


def _ln(x, scale, bias):
    return F.layer_norm(x, x.shape[-1:], scale, bias, 1e-6)


def istft(spec: torch.Tensor, n_fft: int) -> torch.Tensor:
    """(B, N, n_fft/2 + 1) complex frames -> (B, N * hop) samples."""
    hop = n_fft // 4
    b, n, _ = spec.shape
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float64, device=spec.device)
    frames = torch.fft.irfft(spec.to(torch.complex128), n=n_fft) * window        # (B, N, n_fft)
    length = (n - 1) * hop + n_fft
    idx = (torch.arange(n, device=spec.device)[:, None] * hop
           + torch.arange(n_fft, device=spec.device)[None, :]).reshape(-1)
    out = torch.zeros(b, length, dtype=torch.float64, device=spec.device)
    out.index_add_(1, idx, frames.reshape(b, -1))
    wss = torch.zeros(length, dtype=torch.float64, device=spec.device)
    wss.index_add_(0, idx, (window ** 2).repeat(n))
    trim = (n_fft - hop) // 2
    sl = slice(trim, trim + n * hop)
    return (out[:, sl] / torch.clamp(wss[sl], min=1e-8)).float()


def generate(p: dict, v: dict, mel: torch.Tensor, q=lambda t: t) -> torch.Tensor:
    """(B, T, n_mels) -> (B, T * hop) float32."""
    w = p["embed_w"].permute(2, 1, 0)
    x = F.conv1d(q(mel.transpose(1, 2)), q(w), p["embed_b"], padding=3).transpose(1, 2)
    x = _ln(x, p["norm_in_scale"], p["norm_in_bias"])
    approx = "tanh" if v["gelu_approximate"] else "none"
    for i in range(v["num_layers"]):
        b = f"blocks.{i}"
        dw = p[f"{b}.dwconv_w"].reshape(7, -1).t()[:, None, :]                    # (C, 1, 7)
        h = F.conv1d(q(x.transpose(1, 2)), q(dw), p[f"{b}.dwconv_b"], padding=3,
                     groups=x.shape[-1]).transpose(1, 2)
        h = _ln(h, p[f"{b}.norm_scale"], p[f"{b}.norm_bias"])
        a = F.gelu(q(h) @ q(p[f"{b}.pw1_w"]) + p[f"{b}.pw1_b"], approximate=approx)
        x = x + p[f"{b}.gamma"] * (q(a) @ q(p[f"{b}.pw2_w"]) + p[f"{b}.pw2_b"])
    x = _ln(x, p["norm_out_scale"], p["norm_out_bias"])
    n_bins = v["istft_n_fft"] // 2 + 1
    spec = q(x) @ q(p["head_w"]) + p["head_b"]
    mag = torch.exp(torch.clamp(spec[..., :n_bins], max=math.log(100.0)))
    phase = spec[..., n_bins:]
    return istft(torch.polar(mag, phase), v["istft_n_fft"])


def flops(v: dict, frames: int) -> list[tuple[float, str]]:
    """FLOPs for `frames` mel frames as (FLOPs, dtype) parts: the embed conv
    and the ConvNeXt blocks in the vocoder's dtype; the head Linear and the
    inverse FFT (counted as 2.5 N log2 N a frame) in fp32."""
    dim, inner, n_fft = v["dim"], v["intermediate_dim"], v["istft_n_fft"]
    trunk = conv_flops(frames, v["n_mels"], dim, 7)
    trunk += v["num_layers"] * convnext_block_cost(1, frames, dim, inner, 7, "float32")[0]
    head = 2.0 * frames * dim * (n_fft + 2) + frames * 2.5 * n_fft * math.log2(n_fft)
    return [(trunk, v["dtype"]), (head, "float32")]
