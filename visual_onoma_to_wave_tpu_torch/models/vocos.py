"""Vocos vocoder, inference (port of visual_onoma_to_wave_tpu/models/vocos.py).

Mel (B, T, n_mels) feature-last -> waveform (B, T * n_fft / 4): a k=7 embed
conv, LayerNorm, `num_layers` ConvNeXt blocks at mel rate, LayerNorm, an
fp32 head Linear dim -> 2 * (n_fft / 2 + 1) giving log-magnitude and phase,
mag = exp(min(logmag, ln 100)), and the n_fft = 1024 iSTFT head
(`models/istftnet.py`). The published mel-Vocos widths are the defaults
(dim 512, intermediate 1536, 8 blocks; Siuzdak, arXiv:2306.00814).

Under `.eval()` every ConvNeXt block runs through `ops/convnext.py::
convnext_block`: the CUDA kernel on the card, its plain version on the CPU.
That is the JAX package's serving form (`fused_kernel=True`), with the erf
GELU served by the kernel too. Under `.train()` every block takes the plain
version with autograd on any device (the kernel has no backward), as the MHA
of the acoustic model does.
`apply_fused` runs the whole trunk as one `convnext_trunk` launch. On the card
each block keeps its weights packed for the kernel, and the generator keeps
the blocks' weights stacked (and packed) for the trunk, both made again only
when a weight changed (a new tensor, or an in-place write such as
`load_state_dict`, which bumps its version counter).

`dtype` is the trunk's compute dtype (JAX vocos.py:55-79, :93-126, :154-172):
in bfloat16 the embed conv computes in bf16 (its output rounded once, the
bias added in bf16), the LayerNorms take fp32 statistics and return bf16,
and every block (B4 on the card, B5 through `apply_fused`) runs in bf16;
the head Linear and the iSTFT stay fp32.

Parameters keep the flax names and shapes (this family is self-trained, so
there is no reference PyTorch layout): flax `params/<name>` is the torch
parameter `<name>`, and `params/block_<i>/<name>` is `blocks.<i>.<name>`
(`bridge.vocos_state_dict`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from visual_onoma_to_wave_tpu_torch.models.istftnet import _MAX_MAG, istft_overlap_add
from visual_onoma_to_wave_tpu_torch.ops.convnext import (
    convnext_block,
    convnext_block_reference,
    convnext_trunk,
    pack_convnext_weights,
)
from visual_onoma_to_wave_tpu_torch.precision import in_dtype


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Feature LayerNorm with fp32 statistics, output in x's dtype."""
    h = x.float()
    mu = h.mean(-1, keepdim=True)
    var = (h - mu).square().mean(-1, keepdim=True)
    h = (h - mu) * torch.rsqrt(var + eps)
    return (h * scale + bias).to(x.dtype)


def _identity(dtype: torch.dtype, params) -> tuple:
    """What a cache of packed weights is keyed by: the operand type and each
    parameter's device, data pointer and version counter."""
    return (dtype,) + tuple((p.device, p.data_ptr(), p._version) for p in params)


def _trunc_normal(*shape: int) -> nn.Parameter:
    """flax truncated_normal(0.02): N(0, 0.02) cut at two standard deviations."""
    return nn.Parameter(nn.init.trunc_normal_(torch.empty(shape), std=0.02, a=-0.04, b=0.04))


class ConvNeXtBlock(nn.Module):
    """depthwise k=7 -> LN -> Linear dim->mid -> GELU -> Linear mid->dim ->
    gamma * -> +x, served by the `convnext_block` kernel."""

    def __init__(self, dim: int, intermediate_dim: int, layer_scale_init: float,
                 kernel_size: int = 7, gelu_approximate: bool = True):
        super().__init__()
        self.gelu_approximate = gelu_approximate
        self.dwconv_w = _trunc_normal(kernel_size, 1, dim)
        self.dwconv_b = nn.Parameter(torch.zeros(dim))
        self.norm_scale = nn.Parameter(torch.ones(dim))
        self.norm_bias = nn.Parameter(torch.zeros(dim))
        self.pw1_w = _trunc_normal(dim, intermediate_dim)
        self.pw1_b = nn.Parameter(torch.zeros(intermediate_dim))
        self.pw2_w = _trunc_normal(intermediate_dim, dim)
        self.pw2_b = nn.Parameter(torch.zeros(dim))
        self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale_init)))
        self._packed: tuple | None = None   # (identity, packed pw1_w and pw2_w)

    def weights(self) -> tuple[torch.Tensor, ...]:
        """The kernel's operands, in `convnext_block`'s order."""
        return (self.dwconv_w, self.dwconv_b, self.norm_scale, self.norm_bias, self.pw1_w,
                self.pw1_b, self.pw2_w, self.pw2_b, self.gamma)

    def packed(self, dtype: torch.dtype) -> torch.Tensor:
        """pw1_w and pw2_w packed for the kernel in `dtype`
        (`pack_convnext_weights`), packed again only when either changed."""
        if torch.compiler.is_exporting():    # fake tensors: packed inside the traced graph
            return pack_convnext_weights(self.pw1_w, self.pw2_w, dtype)
        key = _identity(dtype, (self.pw1_w, self.pw2_w))
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_convnext_weights(self.pw1_w, self.pw2_w, dtype))
        return self._packed[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:    # the kernel has no backward: GAN training takes the plain block
            return convnext_block_reference(x, *self.weights(),
                                            gelu_approximate=self.gelu_approximate)
        packed = self.packed(x.dtype) if x.device.type == "cuda" else None
        return convnext_block(x, *self.weights(), gelu_approximate=self.gelu_approximate,
                              packed=packed)


class VocosGenerator(nn.Module):
    def __init__(self, n_mels: int = 80, dim: int = 512, intermediate_dim: int = 1536,
                 num_layers: int = 8, embed_kernel_size: int = 7, istft_n_fft: int = 1024,
                 gelu_approximate: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embed_kernel_size = embed_kernel_size
        self.istft_n_fft = istft_n_fft
        self.gelu_approximate = gelu_approximate
        self.embed_w = _trunc_normal(embed_kernel_size, n_mels, dim)
        self.embed_b = nn.Parameter(torch.zeros(dim))
        self.norm_in_scale = nn.Parameter(torch.ones(dim))
        self.norm_in_bias = nn.Parameter(torch.zeros(dim))
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(dim, intermediate_dim, layer_scale_init=1.0 / num_layers,
                          gelu_approximate=gelu_approximate)
            for _ in range(num_layers))
        self.norm_out_scale = nn.Parameter(torch.ones(dim))
        self.norm_out_bias = nn.Parameter(torch.zeros(dim))
        n_bins = istft_n_fft // 2 + 1
        self.head_w = _trunc_normal(dim, 2 * n_bins)
        self.head_b = nn.Parameter(torch.zeros(2 * n_bins))
        self._stacked: tuple | None = None   # (identity, stacked weights, packed)

    @property
    def istft_hop(self) -> int:
        return self.istft_n_fft // 4

    @property
    def total_upsample(self) -> int:
        return self.istft_hop

    def embed(self, mel: torch.Tensor) -> torch.Tensor:
        """k=7 conv n_mels -> dim (zero padding) in the compute dtype and the
        input LayerNorm; the flax kernel (K, n_mels, dim) is the Conv1d weight
        (dim, n_mels, K)."""
        pad = (self.embed_kernel_size - 1) // 2
        w = self.embed_w.permute(2, 1, 0)
        x = in_dtype(F.conv1d, mel.transpose(1, 2), w, self.embed_b, self.dtype,
                     padding=pad).transpose(1, 2)
        return _layer_norm(x, self.norm_in_scale, self.norm_in_bias)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Output LayerNorm, the fp32 head Linear, and the iSTFT."""
        x = _layer_norm(x, self.norm_out_scale, self.norm_out_bias)
        n_bins = self.istft_n_fft // 2 + 1
        spec = x.float() @ self.head_w + self.head_b
        logmag, phase = spec[..., :n_bins], spec[..., n_bins:]
        mag = torch.exp(torch.clamp(logmag, max=math.log(_MAX_MAG)))
        frames_ri = torch.cat([mag * torch.cos(phase), mag * torch.sin(phase)], dim=-1)
        return istft_overlap_add(frames_ri, self.istft_n_fft)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.embed(mel)
        for block in self.blocks:
            x = block(x)
        return self.head(x)

    def stacked_blocks(self, dtype: torch.dtype) -> tuple[list[torch.Tensor], torch.Tensor | None]:
        """The blocks' weights stacked on a leading layer axis, in
        `convnext_trunk`'s order, and on the card their packed stream in
        `dtype`; stacked again only when a weight changed."""
        params = [p for block in self.blocks for p in block.weights()]
        key = _identity(dtype, params)
        if self._stacked is None or self._stacked[0] != key:
            with torch.no_grad():
                stacked = [torch.stack(ws) for ws in zip(*(b.weights() for b in self.blocks))]
                packed = (pack_convnext_weights(stacked[4], stacked[6], dtype)
                          if stacked[4].device.type == "cuda" else None)
            self._stacked = (key, stacked, packed)
        return self._stacked[1], self._stacked[2]

    def receptive_halo_frames(self) -> int:
        """One-sided receptive field in input mel frames: the iSTFT head's
        frame span plus the conv half-widths (the reference's derivation)."""
        hop = self.istft_hop
        head_pad = (self.istft_n_fft - hop) // 2
        halo = max(-(-(self.istft_n_fft - 1 - head_pad) // hop),
                   -(-(self.istft_n_fft - hop) // hop))
        halo += (self.embed_kernel_size - 1) // 2
        halo += len(self.blocks) * 3  # depthwise k=7 per block
        return halo


@torch.inference_mode()
def apply_fused(gen: VocosGenerator, mel: torch.Tensor) -> torch.Tensor:
    """`gen(mel)` with the whole ConvNeXt trunk as one `convnext_trunk`
    launch (the weights stacked once, `VocosGenerator.stacked_blocks`) instead
    of one launch per block."""
    x = gen.embed(mel)
    stacked, packed = gen.stacked_blocks(x.dtype)
    x = convnext_trunk(x, *stacked, gelu_approximate=gen.gelu_approximate, packed=packed)
    return gen.head(x)
