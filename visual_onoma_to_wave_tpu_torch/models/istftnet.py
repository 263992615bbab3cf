"""The iSTFT head (port of the head of visual_onoma_to_wave_tpu/models/istftnet.py).

Only what the Vocos generator needs so far: the magnitude cap, the fixed
synthesis basis (irfft + Hann window as one (2*n_bins, n_fft) matrix), the
window sum-square normaliser and `istft_overlap_add`. The basis and the
normaliser are numpy constants, computed in float64 as the reference does;
the basis product is a plain fp32 matrix product (`torch.matmul`, IEEE fp32
with TF32 off, as the reference's Precision.HIGHEST), followed by the 4-way
shifted add of the hop = n_fft / 4 overlap. The iSTFTNet generators
themselves are not ported yet (ROADMAP A8).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from visual_onoma_to_wave_tpu_torch.ops.stft import hann_window

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


@functools.lru_cache(maxsize=16)
def _on_device(n_fft: int, n_frames: int, device: torch.device):
    """The basis and the normaliser as tensors on `device`, copied once."""
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
