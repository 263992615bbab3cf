"""Visual feature extractor (port of visual_onoma_to_wave_tpu/models/vfe.py).

Per-character image cells (B, n_chars, H, Wc) in [0, 1] -> (B, n_chars,
embed_dim): `layer_num` x [Conv2d 3x3 SAME -> BatchNorm -> ReLU] over all
B*n_chars cells at once, then flatten + Linear bridge + ReLU. The flatten is
PyTorch's NCHW (channel, row, column) order, as in the reference model; the
JAX module flattens NHWC, and `bridge.py` reorders the bridge rows between
the two (they coincide for the shipped one-channel grayscale cells).
"""
from __future__ import annotations

import torch
from torch import nn


class VisualFeatureExtractor(nn.Module):
    def __init__(self, embed_dim: int = 256, cell_hw: tuple[int, int] = (24, 102),
                 kernel_size=(3, 3), num_convolutions: int = 3, channels: int = 1):
        super().__init__()
        if kernel_size[0] % 2 == 0 or kernel_size[1] % 2 == 0:
            raise ValueError(f"conv2d kernel sizes must be odd; got {kernel_size}")
        self.channels = channels
        layers = []
        for _ in range(num_convolutions):
            layers += [nn.Conv2d(channels, channels, tuple(kernel_size), padding="same"),
                       nn.BatchNorm2d(channels, eps=1e-5), nn.ReLU()]
        self.embedder = nn.Sequential(*layers)
        h, w = cell_hw
        self.bridge = nn.Sequential(nn.Linear(h * w * channels, embed_dim), nn.ReLU())

    def forward(self, cells: torch.Tensor) -> torch.Tensor:
        B, C, H, W = cells.shape
        x = cells.reshape(B * C, 1, H, W)
        if self.channels == 3:
            # RGB-scale: the grayscale glyph replicated per channel
            x = x.expand(-1, 3, -1, -1)
        x = self.embedder(x)
        return self.bridge(x.reshape(B * C, -1)).reshape(B, C, -1)
