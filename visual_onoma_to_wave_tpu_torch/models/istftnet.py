"""iSTFTNet generators and the iSTFT head (port of visual_onoma_to_wave_tpu/models/istftnet.py).

The head, shared with Vocos: the magnitude cap, the fixed synthesis basis
(irfft + Hann window as one (2*n_bins, n_fft) matrix), the window sum-square
normaliser and `istft_overlap_add`. The basis and the normaliser are numpy
constants, computed in float64 as the reference does; the basis product is a
plain fp32 matrix product (`torch.matmul`, IEEE fp32 with TF32 off, as the
reference's Precision.HIGHEST), followed by the 4-way shifted add of the
hop = n_fft / 4 overlap.

The generators: HiFi-GAN's trunk (conv_pre, transposed-conv upsampling,
multi-receptive-field stages of `ResBlock1` branches) stopped early, then
leaky ReLU 0.01, `conv_post` to log-magnitude and phase, and the iSTFT. The
presets are C8C8I (two x8 stages, 16-point iSTFT) and melrate (no learned
upsampling, one MRF stage at mel rate, 1024-point iSTFT). Module names are
those of the port's HiFi-GAN (`conv_pre`, `ups.i`, `resblocks.r` with
r = i * 3 + j, `conv_post`), so `bridge.hifigan_state_dict` maps the JAX
tree. On the card every MRF stage of a generator in `.eval()` is one launch
of the fused MRF kernel (`ops/mrf.py`, `csrc/mrf.cu`); on the CPU, and in
`.train()` on any device (the kernel has no backward), it runs through the
`ResBlock1` modules. `dtype` is the trunk's compute dtype (JAX
istftnet.py:157-198): in bfloat16 conv_pre, the upsampling and the MRF stages
compute in bf16 (on the card B2's bf16 instantiation), and conv_post and the
iSTFT head in fp32.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from visual_onoma_to_wave_tpu_torch.models.hifigan import LRELU_SLOPE, ResBlock1
from visual_onoma_to_wave_tpu_torch.ops.mrf import MRFStages
from visual_onoma_to_wave_tpu_torch.ops.stft import hann_window
from visual_onoma_to_wave_tpu_torch.precision import at_dtype, leaky_relu

# mag = exp(min(logmag, ln(_MAX_MAG))), as the reference caps it
_MAX_MAG = 100.0


@functools.lru_cache(maxsize=None)
def istft_synthesis_kernel(n_fft: int) -> np.ndarray:
    """(2*n_bins, n_fft) float32: rows [Re X_0..Re X_nb-1, Im X_0..Im X_nb-1]
    map to the windowed frame w[t] * irfft(X)[t]."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft, dtype=np.float64)
    k = np.arange(n_bins, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(k, t) / n_fft
    scale = np.full((n_bins, 1), 2.0 / n_fft)
    scale[0] = 1.0 / n_fft
    if n_fft % 2 == 0:
        scale[-1] = 1.0 / n_fft
    w = hann_window(n_fft).astype(np.float64)[None, :]
    kernel = np.concatenate([scale * np.cos(ang) * w, -scale * np.sin(ang) * w], axis=0)
    return kernel.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _wss_trimmed(n_frames: int, n_fft: int) -> np.ndarray:
    """Window sum-square of the trimmed overlap-add output, floored at 1e-8."""
    hop = n_fft // 4
    w2 = hann_window(n_fft).astype(np.float64) ** 2
    full = np.zeros((n_frames - 1) * hop + n_fft)
    for i in range(n_frames):
        full[i * hop: i * hop + n_fft] += w2
    trim = (n_fft - hop) // 2
    return np.maximum(full[trim: trim + n_frames * hop], 1e-8).astype(np.float32)


def _on_device(n_fft: int, n_frames: int, device: torch.device):
    """The basis and the normaliser as tensors on `device`, copied once (under
    `torch.export` made anew: a traced graph holds them as its constants, and
    a cache would keep the trace's fake tensors)."""
    if torch.compiler.is_exporting():
        return _basis_and_norm.__wrapped__(n_fft, n_frames, device)
    return _basis_and_norm(n_fft, n_frames, device)


@functools.lru_cache(maxsize=16)
def _basis_and_norm(n_fft: int, n_frames: int, device: torch.device):
    return (torch.from_numpy(istft_synthesis_kernel(n_fft)).to(device),
            torch.from_numpy(_wss_trimmed(n_frames, n_fft)).to(device))


def istft_overlap_add(frames_ri: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Windowed inverse STFT with hop = n_fft // 4. frames_ri: (B, N,
    2*n_bins) real halves then imaginary halves. Returns (B, N*hop) float32,
    normalised by the window sum-square, the (n_fft - hop) // 2 edge trimmed."""
    hop = n_fft // 4
    b, n, _ = frames_ri.shape
    basis, wss = _on_device(n_fft, n, frames_ri.device)
    y = torch.matmul(frames_ri.float(), basis).reshape(b, n, 4, hop)
    # output block n + q receives sub-block q of frame n
    full = sum(F.pad(y[:, :, q], (0, 0, q, 3 - q)) for q in range(4)).reshape(b, (n + 3) * hop)
    trim = (n_fft - hop) // 2
    return full[:, trim: trim + n * hop] / wss


# named architecture presets (total upsampling 256 = hop_length for both)
ISTFT_PRESETS: dict[str, dict] = {
    # iSTFTNet C8C8I (arXiv:2203.02395 Table 1): two x8 stages, 16-point iSTFT
    "c8c8i": dict(upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16), istft_n_fft=16),
    # mel rate: no learned upsampling, a 1024-point iSTFT
    "melrate": dict(upsample_rates=(), upsample_kernel_sizes=(), istft_n_fft=1024),
}


class ISTFTNetGenerator(nn.Module):
    """Mel (B, T, n_mels) -> waveform (B, T * total_upsample), float32."""

    def __init__(self, upsample_rates=(8, 8), upsample_kernel_sizes=(16, 16),
                 upsample_initial_channel: int = 512, resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilations=((1, 3, 5),) * 3, n_mels: int = 80, istft_n_fft: int = 16,
                 post_kernel_size: int = 7, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        ch0 = upsample_initial_channel
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilations = tuple(tuple(d) for d in resblock_dilations)
        self.istft_n_fft = istft_n_fft
        self.post_kernel_size = post_kernel_size
        self.num_kernels = len(resblock_kernel_sizes)
        self.conv_pre = nn.Conv1d(n_mels, ch0, 7, padding=3)
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(ch0 // 2 ** i, ch0 // 2 ** (i + 1), k, stride=u,
                               padding=(k - u) // 2)
            for i, (u, k) in enumerate(zip(self.upsample_rates, self.upsample_kernel_sizes)))
        # one MRF stage after each upsampling, or one at mel rate without any
        widths = [ch0 // 2 ** (i + 1) for i in range(len(self.ups))] or [ch0]
        self.resblocks = nn.ModuleList(
            ResBlock1(c, rk, rd, dtype) for c in widths
            for rk, rd in zip(self.resblock_kernel_sizes, self.resblock_dilations))
        self.conv_post = nn.Conv1d(widths[-1], 2 * (istft_n_fft // 2 + 1), post_kernel_size,
                                   padding=(post_kernel_size - 1) // 2)
        self._mrf = MRFStages(self.resblock_kernel_sizes, self.resblock_dilations)

    @property
    def istft_hop(self) -> int:
        return self.istft_n_fft // 4

    @property
    def total_upsample(self) -> int:
        return int(np.prod(self.upsample_rates, dtype=np.int64)) * self.istft_hop

    def _stage_blocks(self, i: int):
        n = self.num_kernels
        return self.resblocks[i * n:(i + 1) * n]

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = at_dtype(self.conv_pre, mel.transpose(1, 2), self.dtype)
        for i, up in enumerate(self.ups):
            x = self._mrf(i, self._stage_blocks(i),
                          at_dtype(up, leaky_relu(x, LRELU_SLOPE), self.dtype),
                          fused=not self.training)
        if not self.ups:
            x = self._mrf(0, self._stage_blocks(0), x, fused=not self.training)
        spec = self.conv_post(leaky_relu(x, 0.01).float()).transpose(1, 2)  # head in fp32
        n_bins = self.istft_n_fft // 2 + 1
        logmag, phase = spec[..., :n_bins], spec[..., n_bins:]
        mag = torch.exp(torch.clamp(logmag, max=math.log(_MAX_MAG)))
        frames = torch.cat([mag * torch.cos(phase), mag * torch.sin(phase)], dim=-1)
        return istft_overlap_add(frames, self.istft_n_fft)

    def receptive_halo_frames(self) -> int:
        """One-sided receptive field in input mel frames (for sample-exact
        chunked vocoding), as the reference computes it."""
        hop = self.istft_hop
        pad = (self.istft_n_fft - hop) // 2
        halo = max(-(-(self.istft_n_fft - 1 - pad) // hop), -(-(self.istft_n_fft - hop) // hop))
        halo += (self.post_kernel_size - 1) // 2
        mrf = max(sum((d + 1) * (rk - 1) // 2 for d in rd)
                  for rk, rd in zip(self.resblock_kernel_sizes, self.resblock_dilations))
        if not self.upsample_rates:
            halo += mrf
        for u, k in zip(reversed(self.upsample_rates), reversed(self.upsample_kernel_sizes)):
            halo += mrf
            halo = -(-(halo + k - 1 - (k - u) // 2) // u)
        return halo + 3  # conv_pre k = 7


def build_istftnet(preset: str = "c8c8i", *, dtype: torch.dtype = torch.float32,
                   **overrides) -> ISTFTNetGenerator:
    """An ISTFTNetGenerator of compute dtype `dtype` from a named preset plus
    overrides."""
    kw = dict(ISTFT_PRESETS[preset.lower()])
    kw.update(overrides)
    return ISTFTNetGenerator(dtype=dtype, **kw)
