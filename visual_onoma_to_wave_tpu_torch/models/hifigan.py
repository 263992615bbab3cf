"""HiFi-GAN generator, inference (port of visual_onoma_to_wave_tpu/models/hifigan.py).

Mel (B, T, n_mels) feature-last -> waveform (B, T * prod(upsample_rates)).
Conv1d / ConvTranspose1d(stride u, padding (k - u) // 2) in PyTorch's own
semantics, MRF fusion of ResBlock1 (V1/V2) or ResBlock2 (V3) branches,
leaky ReLU 0.1 inside the network and PyTorch's default 0.01 before
`conv_post`, then tanh. Module names follow the reference checkpoint layout
(conv_pre / ups.N / resblocks.M.convs1|convs2|convs.J / conv_post) that
`visual_onoma_to_wave_tpu/models/hifigan.py::convert_torch_state_dict` reads.
On the card every ResBlock1 stage (V1, V2) is one launch of the fused MRF
kernel (`ops/mrf.py`, `csrc/mrf.cu`), which beat the cuDNN chain at all four
V1 stage shapes (PERF.md); ResBlock2 stages (V3) and every stage on the CPU
run through the modules.
`receptive_halo_frames` and chunked vocoding are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from visual_onoma_to_wave_tpu_torch.ops.mrf import MRFStages

LRELU_SLOPE = 0.1

# official size presets (hifi-gan config_v{1,2,3}.json)
HIFIGAN_PRESETS = {
    "v1": {},
    "v2": {"upsample_initial_channel": 128},
    "v3": {
        "resblock_type": "2",
        "upsample_rates": (8, 8, 4),
        "upsample_kernel_sizes": (16, 16, 8),
        "upsample_initial_channel": 256,
        "resblock_kernel_sizes": (3, 5, 7),
        "resblock_dilations": ((1, 2), (2, 6), (3, 12)),
    },
}


def _conv(c: int, k: int, d: int) -> nn.Conv1d:
    return nn.Conv1d(c, c, k, dilation=d, padding=d * (k - 1) // 2)


class ResBlock1(nn.Module):
    """3x [lrelu -> dilated conv -> lrelu -> conv d=1 -> +x]."""

    def __init__(self, channels: int, kernel_size: int, dilations=(1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList(_conv(channels, kernel_size, d) for d in dilations)
        self.convs2 = nn.ModuleList(_conv(channels, kernel_size, 1) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            h = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = x + h
        return x


class ResBlock2(nn.Module):
    """2x [lrelu -> dilated conv -> +x] (config_v3.json)."""

    def __init__(self, channels: int, kernel_size: int, dilations=(1, 3)):
        super().__init__()
        self.convs = nn.ModuleList(_conv(channels, kernel_size, d) for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = x + c(F.leaky_relu(x, LRELU_SLOPE))
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                 upsample_initial_channel: int = 512, resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilations=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 resblock_type: str = "1", n_mels: int = 80):
        super().__init__()
        ch0 = upsample_initial_channel
        self.num_kernels = len(resblock_kernel_sizes)
        self.conv_pre = nn.Conv1d(n_mels, ch0, 7, padding=3)
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(ch0 // 2 ** i, ch0 // 2 ** (i + 1), k, stride=u,
                               padding=(k - u) // 2)
            for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)))
        block = ResBlock2 if resblock_type == "2" else ResBlock1
        self.resblocks = nn.ModuleList(
            block(ch0 // 2 ** (i + 1), rk, tuple(rd))
            for i in range(len(upsample_rates))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilations))
        self.conv_post = nn.Conv1d(ch0 // 2 ** len(upsample_rates), 1, 7, padding=3)
        self._mrf = (None if resblock_type == "2"
                     else MRFStages(resblock_kernel_sizes, resblock_dilations))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel.transpose(1, 2))
        n = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            blocks = self.resblocks[i * n:(i + 1) * n]
            if self._mrf is not None:
                x = self._mrf(i, blocks, x)
                continue
            acc = None
            for block in blocks:
                y = block(x)
                acc = y if acc is None else acc + y
            x = acc / n
        x = self.conv_post(F.leaky_relu(x, 0.01))  # PyTorch's default slope
        return torch.tanh(x)[:, 0, :]
