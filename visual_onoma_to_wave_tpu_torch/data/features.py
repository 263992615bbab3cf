"""Pass 1 of corpus preprocessing: batch clips on the host, extract features on the device.

Host batching exactly as the reference does it
(visual_onoma_to_wave_tpu/data/preprocess.py:236-250): each clip is clipped
to [-1, 1] and reflect-padded by n_fft // 2 on its own (so the zeros of the
bucket cannot leak into the reflection), the batch is zero-padded to one
bucket of n_fft + 2^k * 32 * hop samples (length-sorted batches then see a
handful of shapes), and the per-character durations are zero-padded to
`max_chars`. `extract_features` ships that batch to the device and runs
`ops/mel.py::fused_clip_features` on it: the CUDA kernel on the card, its
plain version on the CPU.

Torch and numpy only: chip_smoke drives this module without the reference
package.
"""
from __future__ import annotations

import numpy as np
import torch

from visual_onoma_to_wave_tpu_torch.ops.mel import fused_clip_features

BUCKET_HOPS = 32   # bucket lengths step in powers of two of 32 hops


def bucket_length(max_len: int, n_fft: int, hop_length: int) -> int:
    """Padded length of a batch whose longest pre-padded clip has `max_len`
    samples: n_fft + 2^k * 32 * hop, the smallest such length >= max_len
    (k >= 0)."""
    step = BUCKET_HOPS * hop_length
    units = max(1, -(-(max_len - n_fft) // step))
    return n_fft + (1 << (units - 1).bit_length()) * step


def pad_batch(audios: list[np.ndarray], durations: list[np.ndarray], *, n_fft: int,
              hop_length: int, max_chars: int) -> tuple[np.ndarray, np.ndarray]:
    """(B, bucket) float32 pre-padded audio and (B, max_chars) int32 durations."""
    pad = n_fft // 2
    pre = [np.pad(np.clip(a, -1, 1), pad, mode="reflect") for a in audios]
    batch = np.zeros((len(pre), bucket_length(max(len(p) for p in pre), n_fft, hop_length)),
                     np.float32)
    for i, p in enumerate(pre):
        batch[i, :len(p)] = p
    dur = np.zeros((len(pre), max_chars), np.int32)
    for i, d in enumerate(durations):
        dur[i, :len(d)] = d
    return batch, dur


def extract_features(audios: list[np.ndarray], durations: list[np.ndarray], *,
                     device: torch.device | str, max_chars: int, n_fft: int = 1024,
                     hop_length: int = 256, win_length: int = 1024, n_mels: int = 80,
                     sampling_rate: int = 22050, f_min: float = 0.0, f_max: float = 8000.0):
    """Log-mel (B, n_mels, T), char energy and kurtosis (B, max_chars) of a
    batch of clips, as tensors on `device`, not synchronised: the caller
    copies them to the host when it needs them. Frames past a clip's
    sum(durations) are padding."""
    batch, dur = pad_batch(audios, durations, n_fft=n_fft, hop_length=hop_length,
                           max_chars=max_chars)
    return fused_clip_features(
        torch.from_numpy(batch).to(device), torch.from_numpy(dur).to(device), max_chars,
        n_fft, hop_length, win_length, n_mels, sampling_rate, f_min, f_max)
