"""Acoustic-model layers (port of visual_onoma_to_wave_tpu/models/layers.py).

Inference only: dropout is the identity and BatchNorm uses its running
statistics (call `.eval()`). Public functions keep the reference's
feature-last (B, T, C) layout; convolutions transpose to PyTorch's (B, C, T)
internally. Parameter names follow the reference state_dict layout that
`visual_onoma_to_wave_tpu/models/convert_acoustic.py` reads.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from visual_onoma_to_wave_tpu_torch.ops.attention import attention_core


def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    """Fixed sinusoid position table (the reference's, computed in float64)."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    dim = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


class Conv(nn.Module):
    """Conv1d on feature-last input with SAME padding (the reference's
    `ConvNorm`-style wrapper, whose weight sits at `<name>.conv.weight`)."""

    def __init__(self, c_in: int, c_out: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel_size, padding="same")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x.transpose(1, 2)).transpose(1, 2)


class MultiHeadAttention(nn.Module):
    """Post-LN multi-head self-attention with a key-padding mask.

    The softmax core always goes through `ops.attention.attention_core`: the
    CUDA kernel for tensors on the card, its plain version on the CPU, at any
    T and for dk 64 or 128 on the card. The config key `model.fused_attention`,
    which gated the reference's TPU kernel on TPU tiling rules, is ignored:
    the card has one formulation.
    """

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int):
        super().__init__()
        if d_k != d_v:
            raise ValueError(f"attention core needs d_k == d_v; got {d_k}, {d_v}")
        self.n_head = n_head
        self.w_qs = nn.Linear(d_model, n_head * d_k)
        self.w_ks = nn.Linear(d_model, n_head * d_k)
        self.w_vs = nn.Linear(d_model, n_head * d_v)
        self.fc = nn.Linear(n_head * d_v, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x: torch.Tensor, key_pad_mask: torch.Tensor) -> torch.Tensor:
        # x: (B, T, D); key_pad_mask: (B, T) True = padding
        ctx = attention_core(self.w_qs(x), self.w_ks(x), self.w_vs(x),
                             key_pad_mask, self.n_head)
        return self.layer_norm(self.fc(ctx) + x)


class PositionwiseFeedForward(nn.Module):
    """Conv FFN: k=9 expand -> ReLU -> k=1 project, post-LN."""

    def __init__(self, d_in: int, d_hid: int, kernel_size=(9, 1)):
        super().__init__()
        self.w_1 = nn.Conv1d(d_in, d_hid, kernel_size[0], padding="same")
        self.w_2 = nn.Conv1d(d_hid, d_in, kernel_size[1], padding="same")
        self.layer_norm = nn.LayerNorm(d_in, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.w_2(torch.relu(self.w_1(x.transpose(1, 2)))).transpose(1, 2)
        return self.layer_norm(h + x)


class FFTBlock(nn.Module):
    """Attention + conv FFN, each followed by zeroing the padding positions."""

    def __init__(self, d_model: int, n_head: int, d_k: int, d_v: int,
                 d_inner: int, kernel_size=(9, 1)):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_size)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        pad = pad_mask[:, :, None]
        x = self.slf_attn(x, pad_mask).masked_fill(pad, 0.0)
        return self.pos_ffn(x).masked_fill(pad, 0.0)


class VariancePredictor(nn.Module):
    """Two [conv k=3 -> ReLU -> LN] blocks + Linear -> 1, 0 at padding."""

    def __init__(self, d_in: int, filter_size: int = 256, kernel_size: int = 3):
        super().__init__()
        self.conv_layer = nn.ModuleDict({
            "conv1d_1": Conv(d_in, filter_size, kernel_size),
            "layer_norm_1": nn.LayerNorm(filter_size, eps=1e-5),
            "conv1d_2": Conv(filter_size, filter_size, kernel_size),
            "layer_norm_2": nn.LayerNorm(filter_size, eps=1e-5),
        })
        self.linear_layer = nn.Linear(filter_size, 1)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        c = self.conv_layer
        h = c["layer_norm_1"](torch.relu(c["conv1d_1"](x)))
        h = c["layer_norm_2"](torch.relu(c["conv1d_2"](h)))
        return self.linear_layer(h)[..., 0].masked_fill(pad_mask, 0.0)


class PostNet(nn.Module):
    """5-layer conv PostNet: [conv -> BatchNorm -> tanh] x 4, conv -> BatchNorm."""

    def __init__(self, n_mel_channels: int = 80, embedding_dim: int = 512,
                 kernel_size: int = 5, n_convolutions: int = 5):
        super().__init__()
        dims = [n_mel_channels] + [embedding_dim] * (n_convolutions - 1) + [n_mel_channels]
        self.convolutions = nn.ModuleList(
            nn.Sequential(Conv(dims[i], dims[i + 1], kernel_size),
                          nn.BatchNorm1d(dims[i + 1], eps=1e-5))
            for i in range(n_convolutions))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, T, n_mels); BatchNorm1d wants channels second
        h = x.transpose(1, 2)
        last = len(self.convolutions) - 1
        for i, (conv, bn) in enumerate(self.convolutions):
            h = bn(conv.conv(h))
            if i < last:
                h = torch.tanh(h)
        return h.transpose(1, 2)
