"""MelGAN generator, inference (port of visual_onoma_to_wave_tpu/models/melgan.py).

The reference's alternative vocoder (melgan-neurips mel2wav Generator,
loaded by torch.hub in the reference; n_mels 80, ngf 32, 3 residual layers,
ratios 8/8/2/2). It takes log10-domain mels: `synthesis.make_fused_infer`
divides the model's natural-log mel by `LN10`.

    reflect-pad 3 -> conv7 (n_mels -> ngf * 2^len(ratios))
    per ratio r: leaky 0.2 -> ConvTranspose(k 2r, stride r, padding r // 2),
                 channels halve -> ResnetBlock(dilation 3^j) for j < 3
    leaky 0.2 -> reflect-pad 3 -> conv7 (ngf -> 1) -> tanh

ResnetBlock(dim, d) = conv1x1(x) + [leaky 0.2 -> reflect-pad d -> conv3
dilated d -> leaky 0.2 -> conv1x1](x). Only even ratios are taken: padding
r // 2 without output padding equals melgan-neurips's layer only for them.
Modules sit in the sequential `model.{idx}` layout of melgan-neurips, which
`visual_onoma_to_wave_tpu/models/melgan.py::convert_melgan_state_dict`
reads; no kernel of the port runs here (cuDNN convs).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

LRELU_SLOPE = 0.2
LN10 = float(np.log(10.0))


class ResnetBlock(nn.Module):
    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.block = nn.Sequential(
            nn.LeakyReLU(LRELU_SLOPE), nn.ReflectionPad1d(dilation),
            nn.Conv1d(dim, dim, 3, dilation=dilation), nn.LeakyReLU(LRELU_SLOPE),
            nn.Conv1d(dim, dim, 1))
        self.shortcut = nn.Conv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.shortcut(x) + self.block(x)


class MelGANGenerator(nn.Module):
    """log10-domain mel (B, T, n_mels) -> waveform (B, T * prod(ratios))."""

    def __init__(self, n_mels: int = 80, ngf: int = 32, n_residual_layers: int = 3,
                 ratios=(8, 8, 2, 2)):
        super().__init__()
        if any(r % 2 for r in ratios):
            raise ValueError(f"MelGANGenerator takes even upsampling ratios only; got {ratios}")
        ch = 2 ** len(ratios) * ngf
        layers = [nn.ReflectionPad1d(3), nn.Conv1d(n_mels, ch, 7)]
        for r in ratios:
            layers += [nn.LeakyReLU(LRELU_SLOPE),
                       nn.ConvTranspose1d(ch, ch // 2, 2 * r, stride=r, padding=r // 2)]
            ch //= 2
            layers += [ResnetBlock(ch, 3 ** j) for j in range(n_residual_layers)]
        layers += [nn.LeakyReLU(LRELU_SLOPE), nn.ReflectionPad1d(3), nn.Conv1d(ngf, 1, 7),
                   nn.Tanh()]
        self.model = nn.Sequential(*layers)
        self.total_upsample = int(np.prod(ratios, dtype=np.int64))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        return self.model(mel.transpose(1, 2))[:, 0, :]
