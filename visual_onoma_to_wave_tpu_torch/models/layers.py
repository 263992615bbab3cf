"""Acoustic-model layers (port of visual_onoma_to_wave_tpu/models/layers.py).

`.train()` is the reference's `deterministic=False`: dropout at the
reference's sites, BatchNorm on batch statistics, attention through its
plain version with autograd. `.eval()` is `deterministic=True`: no dropout,
BatchNorm on its running statistics, attention through the CUDA kernel on
the card. Dropout masks come from the `torch.Generator` that
`set_dropout_generator` hands every `Dropout` of a model, never from the
global RNG. Under data parallelism over processes (`set_data_parallel`) each
process holds its rows of a global batch: a `Dropout` draws the global
batch's mask and keeps its rows, and a BatchNorm in training normalises by
the global batch's statistics (sums all-reduced with autograd), so that the
processes together compute the one-process step. Public functions keep the reference's feature-last (B, T, C)
layout; convolutions transpose to PyTorch's (B, C, T) internally. Parameter
names follow the reference state_dict layout that
`visual_onoma_to_wave_tpu/models/convert_acoustic.py` reads.

Compute dtype (`dtype`, the JAX modules' field of that name): in bfloat16
the attention's projections, its product with V and its output projection,
the conv FFN and the PostNet's first four convolutions run in bf16 with fp32
parameters (`precision.at_dtype`); the attention logits and softmax, every
LayerNorm (on the fp32 sum of the sub-block and its residual), the
BatchNorms and the PostNet's last convolution stay fp32, and so does every
block's output. In float32 every module computes what it computed before the
dtype existed.

Initialisation is flax's, leaf by leaf (`init_like_flax`): lecun-normal
kernels (a normal truncated at two standard deviations, scaled to variance
1/fan_in) and zero biases for every linear and convolution, N(0, 1/features)
embeddings, ones and zeros for the norms; the visual feature extractor
draws everything from U(-0.08, 0.08) (`models/vfe.py`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from visual_onoma_to_wave_tpu_torch.ops.attention import (
    attention_core,
    attention_core_reference,
)
from visual_onoma_to_wave_tpu_torch.precision import at_dtype


def sinusoid_position_table(n_position: int, d_hid: int) -> np.ndarray:
    """Fixed sinusoid position table (the reference's, computed in float64)."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    dim = np.arange(d_hid, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)


class Dropout(nn.Module):
    """Inverted dropout whose masks come from `self.generator` (a
    `torch.Generator`, set by `set_dropout_generator`); the identity under
    `.eval()` or at rate 0. The mask is drawn on the generator's own device
    and moved to the input's, so a CPU generator gives a model on the card
    the CPU's masks bit for bit; without a generator it is drawn on the
    input's device from the global RNG."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None
        self.shard: tuple[int, int] | None = None   # (process, processes): see set_data_parallel

    def keep_mask(self, x: torch.Tensor) -> torch.Tensor:
        """The boolean mask of the elements of `x` that this call keeps; with
        a shard, this process's rows of the global batch's mask."""
        device = self.generator.device if self.generator is not None else x.device
        if self.shard is None:
            keep = torch.rand(x.shape, generator=self.generator, device=device) >= self.p
        else:
            p, n = self.shard
            b = x.shape[0]
            keep = torch.rand((b * n, *x.shape[1:]), generator=self.generator,
                              device=device)[p * b:(p + 1) * b] >= self.p
        return keep.to(x.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        return torch.where(self.keep_mask(x), x / (1.0 - self.p), 0.0)


def set_dropout_generator(model: nn.Module, generator: torch.Generator | None) -> None:
    """Every `Dropout` of `model` draws its masks from `generator`."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


def set_data_parallel(model: nn.Module, shard: tuple[int, int] | None) -> None:
    """`shard` = (process, processes): every `Dropout` and flax BatchNorm of
    `model` works on this process's equal share of a global batch (module
    docstring); None: the whole batch is here."""
    for m in model.modules():
        if isinstance(m, (Dropout, _FlaxBatchNorm)):
            m.shard = shard


class _FlaxBatchNorm:
    """flax `nn.BatchNorm(momentum=0.9)` semantics for torch's BatchNorm
    modules (same parameter and buffer names; flax's momentum 0.9 is torch's
    0.1, the default). Training: normalise by the batch mean and the biased
    variance E[x^2] - E[x]^2, and move the running statistics 10% of the way
    to them, the running variance to the *biased* batch variance (torch
    would use the unbiased one). Eval: the running statistics, as torch does.
    With a shard (`set_data_parallel`) the batch statistics are the global
    batch's: the sums of x and x^2 are all-reduced over the processes with
    autograd, so the gradient flows through every process's rows."""

    shard: tuple[int, int] | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.ndim))
        shape = [1, -1] + [1] * (x.ndim - 2)
        if self.shard is None:
            mean, sq = x.mean(dims), (x * x).mean(dims)
        else:
            from visual_onoma_to_wave_tpu_torch.parallel.distributed import all_reduce_sum

            count = x.numel() // x.shape[1] * self.shard[1]
            sums = all_reduce_sum(torch.stack([x.sum(dims), (x * x).sum(dims)]))
            mean, sq = sums[0] / count, sums[1] / count
        var = torch.clamp(sq - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(self.momentum * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


def lecun_normal_(w: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's default kernel init: N(0, 1) truncated to [-2, 2], scaled to
    variance 1/fan_in (the 0.8796 undoes the truncation's shrink)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)


@torch.no_grad()
def init_like_flax(model: nn.Module, skip=()) -> None:
    """Re-initialise every leaf of `model` from the distribution flax gives
    its counterpart: Linear and Conv weights lecun-normal (fan_in = in
    features x kernel taps), biases 0, Embedding N(0, 1/features), LayerNorm
    and BatchNorm 1 and 0 with running statistics 0 and 1. Modules under a
    module in `skip` keep theirs."""
    skipped = {id(m) for s in skip for m in s.modules()}
    for m in model.modules():
        if id(m) in skipped:
            continue
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d)):
            lecun_normal_(m.weight, m.weight[0].numel())
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, 0.0, 1.0 / math.sqrt(m.weight.shape[1]))
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                m.reset_running_stats()


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

    Under `.eval()` the softmax core goes through `ops.attention.attention_core`:
    the CUDA kernel for tensors on the card, its plain version on the CPU, at
    any T and for dk 64 or 128 on the card. Under `.train()` it takes the plain
    version (`attention_core_reference`) with autograd through it, as the
    reference takes its XLA path whenever it is not deterministic: the kernel
    has no backward. The config key `model.fused_attention`, which gated the
    reference's TPU kernel on TPU tiling rules, is ignored. In bf16 the core
    takes bf16 projections (the kernel's bf16 instantiation on the card).
    """

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if d_k != d_v:
            raise ValueError(f"attention core needs d_k == d_v; got {d_k}, {d_v}")
        self.n_head = n_head
        self.dtype = dtype
        self.w_qs = nn.Linear(d_model, n_head * d_k)
        self.w_ks = nn.Linear(d_model, n_head * d_k)
        self.w_vs = nn.Linear(d_model, n_head * d_v)
        self.fc = nn.Linear(n_head * d_v, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, key_pad_mask: torch.Tensor) -> torch.Tensor:
        # x: (B, T, D); key_pad_mask: (B, T) True = padding
        core = attention_core_reference if self.training else attention_core
        q, k, v = (at_dtype(m, x, self.dtype) for m in (self.w_qs, self.w_ks, self.w_vs))
        out = self.dropout(at_dtype(self.fc, core(q, k, v, key_pad_mask, self.n_head), self.dtype))
        return self.layer_norm(out.float() + x.float())


class PositionwiseFeedForward(nn.Module):
    """Conv FFN: k=9 expand -> ReLU -> k=1 project, post-LN."""

    def __init__(self, d_in: int, d_hid: int, kernel_size=(9, 1), dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.w_1 = nn.Conv1d(d_in, d_hid, kernel_size[0], padding="same")
        self.w_2 = nn.Conv1d(d_hid, d_in, kernel_size[1], padding="same")
        self.layer_norm = nn.LayerNorm(d_in, eps=1e-5)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = at_dtype(self.w_1, x.transpose(1, 2), self.dtype)
        h = at_dtype(self.w_2, torch.relu(h), self.dtype).transpose(1, 2)
        return self.layer_norm(self.dropout(h).float() + x.float())


class FFTBlock(nn.Module):
    """Attention + conv FFN, each followed by zeroing the padding positions."""

    def __init__(self, d_model: int, n_head: int, d_k: int, d_v: int,
                 d_inner: int, kernel_size=(9, 1), dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, d_k, d_v, dropout, dtype)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_size, dropout, dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        pad = pad_mask[:, :, None]
        x = self.slf_attn(x, pad_mask).masked_fill(pad, 0.0)
        return self.pos_ffn(x).masked_fill(pad, 0.0)


class VariancePredictor(nn.Module):
    """Two [conv k=3 -> ReLU -> LN -> dropout] blocks + Linear -> 1, 0 at padding."""

    def __init__(self, d_in: int, filter_size: int = 256, kernel_size: int = 3,
                 dropout: float = 0.5):
        super().__init__()
        self.conv_layer = nn.ModuleDict({
            "conv1d_1": Conv(d_in, filter_size, kernel_size),
            "layer_norm_1": nn.LayerNorm(filter_size, eps=1e-5),
            "conv1d_2": Conv(filter_size, filter_size, kernel_size),
            "layer_norm_2": nn.LayerNorm(filter_size, eps=1e-5),
        })
        self.linear_layer = nn.Linear(filter_size, 1)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        c = self.conv_layer
        h = self.dropout(c["layer_norm_1"](torch.relu(c["conv1d_1"](x))))
        h = self.dropout(c["layer_norm_2"](torch.relu(c["conv1d_2"](h))))
        return self.linear_layer(h)[..., 0].masked_fill(pad_mask, 0.0)


class PostNet(nn.Module):
    """5-layer conv PostNet: [conv -> BatchNorm -> tanh -> dropout] x 4,
    conv -> BatchNorm -> dropout (the reference drops after the last layer too).
    In bf16 the first convolutions run in bf16 and the last in fp32; every
    BatchNorm normalises an fp32 input."""

    def __init__(self, n_mel_channels: int = 80, embedding_dim: int = 512,
                 kernel_size: int = 5, n_convolutions: int = 5, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        dims = [n_mel_channels] + [embedding_dim] * (n_convolutions - 1) + [n_mel_channels]
        self.convolutions = nn.ModuleList(
            nn.Sequential(Conv(dims[i], dims[i + 1], kernel_size),
                          BatchNorm1d(dims[i + 1], eps=1e-5))
            for i in range(n_convolutions))
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, T, n_mels); BatchNorm1d wants channels second
        h = x.transpose(1, 2)
        last = len(self.convolutions) - 1
        for i, (conv, bn) in enumerate(self.convolutions):
            h = bn(at_dtype(conv.conv, h, self.dtype if i < last else torch.float32).float())
            if i < last:
                h = torch.tanh(h)
            h = self.dropout(h)
        return h.transpose(1, 2)
