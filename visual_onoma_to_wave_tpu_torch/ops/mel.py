"""Fused mel-spectrogram frontend of corpus preprocessing: CUDA kernel + plain PyTorch version.

Replaces the TPU kernel `visual_onoma_to_wave_tpu/ops/pallas_mel.py::
_run_mel_kernel` and its two entry points. For a batch of reflect-pre-padded
clips `prepadded` (B, L), T = (L - n_fft) // hop + 1 frames:

    mel_frontend(prepadded, ...) -> logmel (B, n_mels, T), energy, power_sum,
                                    log_power_sum (each (B, T))

logmel = log(max(fb^T |rfft(clip(frame) * w)|, 1e-5)); energy the L2 norm of
|rfft| over the n_fft // 2 + 1 bins, power_sum its square, log_power_sum
the sum of log(|rfft|^2 + 1e-8) (the two kurtosis moments). w is the Hann
window of win_length zero-padded to the centre of n_fft. The JAX kernel's
three spare mel columns become their own outputs here.

The kernel takes the FFT and each bin's power in float64 and the rest in
fp32 (its log-mel is within 1e-5 of the float64 result); the plain version
is fp32 throughout (`torch.fft.rfft`), as the JAX package's functions are.
Where they differ, near the log's 1e-5 clamp, the plain version is the
noisier.

`fused_logmel_energy` and `fused_clip_features` are the counterparts of
`pallas_logmel_energy` and `pallas_clip_features`; the second reduces the
per-frame sums to char energy and kurtosis with
`ops/stft.py::char_stats_from_frame_sums`.

`mel_frontend` launches the CUDA kernel (`csrc/mel_frontend.cu`, built at
first use by `ops/cuda_build.py`) for tensors on the card and takes
`mel_frontend_reference` for tensors on the CPU. It never falls back: a
shape the kernel does not take (n_fft not a power of two in [16, 2048],
win_length > n_fft, L < n_fft, audio not fp32 (B, L)), another device, a
failed build, a refused launch or a call that would need a gradient raises.
Any hop and any T are taken (the TPU kernel's n_fft % hop == 0 and its
tile padding are layout rules of the TPU). Launches are counted in
`mel_frontend.launches`.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from visual_onoma_to_wave_tpu_torch.ops.cuda_build import (
    check_inference,
    check_launch,
    load_library,
)
from visual_onoma_to_wave_tpu_torch.ops.stft import (
    KURTOSIS_EPS,
    char_stats_from_frame_sums,
    framed_magnitude,
    hann_window,
    melscale_fbanks,
    pad_window,
)

MIN_N_FFT, MAX_N_FFT = 16, 2048   # the kernel's instantiations: 8- to 1024-point complex FFTs
_MAX_BATCH = 65535                # grid y
# the kernel's block geometry (`THREADS`, `ROUNDS`, `LANE_VALUES` in
# csrc/mel_frontend.cu): threads a block, rounds of frames a block takes,
# complex float64 values a lane holds
THREADS, ROUNDS, LANE_VALUES = 128, 4, 16


def block_frames(n_fft: int) -> int:
    """Frames one block of the kernel takes at n_fft: ROUNDS rounds of
    THREADS / (lanes a frame), a frame taking n_fft / 2 / LANE_VALUES lanes
    (one at n_fft <= 32)."""
    return ROUNDS * THREADS // max(1, n_fft // 2 // LANE_VALUES)


def fft_plan(n_fft: int) -> list[tuple[int, int]]:
    """The kernel's FFT over n_fft / 2 complex points as (radix, stride) per
    Stockham pass: one radix-2 or radix-4 pass where log2(n_fft / 2) is not a
    multiple of 3, then radix-8 passes; pass p reads stride Ns = the product
    of the earlier radices (`Plan` in `csrc/mel_frontend.cu`)."""
    log2_half = (n_fft // 2).bit_length() - 1
    radices = ([1 << (log2_half % 3)] if log2_half % 3 else []) + [8] * (log2_half // 3)
    strides = np.cumprod([1] + radices[:-1]).tolist()
    return list(zip(radices, strides))


def twiddle_table(n_fft: int) -> np.ndarray:
    """The kernel's float64 twiddles (entries, 2) as (cos, -sin): first
    W_{n_fft}^k for k < n_fft / 2 (the split of the packed real FFT), then
    for each pass after the first, radix R and stride Ns, the block
    W_{Ns R}^{s r} at row (r - 1) * Ns + s for 1 <= r < R and s < Ns."""
    angles = [2.0 * np.pi * np.arange(n_fft // 2, dtype=np.float64) / n_fft]
    for radix, stride in fft_plan(n_fft)[1:]:
        r = np.arange(1, radix, dtype=np.float64)[:, None]
        s = np.arange(stride, dtype=np.float64)[None, :]
        angles.append((2.0 * np.pi * r * s / (stride * radix)).ravel())
    ang = np.concatenate(angles)
    return np.stack([np.cos(ang), -np.sin(ang)], axis=-1)


@functools.lru_cache(maxsize=8)
def _host_constants(n_fft: int, win_length: int, n_mels: int, sampling_rate: int,
                    f_min: float, f_max: float):
    """The kernel's constants: the padded fp32 window (n_fft,); the float64
    twiddle table (`twiddle_table`); per mel filter its non-zero bin range
    and offset (3, n_mels) int32 and the packed fp32 weights; and the dense
    fp32 filterbank (F, n_mels) of the plain version. Window and filterbank
    are the plain version's own."""
    window = pad_window(torch.from_numpy(hann_window(win_length)), n_fft).numpy()
    twiddle = twiddle_table(n_fft)
    fb = melscale_fbanks(n_fft // 2 + 1, f_min, f_max, n_mels, sampling_rate)
    index = np.zeros((3, n_mels), np.int32)
    weights, offset = [], 0
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        index[:, m] = (lo, hi, offset)
        weights.append(fb[lo:hi, m])
        offset += hi - lo
    packed = np.concatenate(weights + [np.zeros(1, np.float32)])  # never empty
    return window, twiddle, index, packed, fb


@functools.lru_cache(maxsize=16)
def _on_device(key: tuple, device: torch.device):
    """`_host_constants(*key)` as tensors on `device`, copied once."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in _host_constants(*key))


def mel_frontend_reference(prepadded: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                           win_length: int = 1024, n_mels: int = 80,
                           sampling_rate: int = 22050, f_min: float = 0.0,
                           f_max: float = 8000.0):
    """Plain PyTorch version of the kernel (torch.fft.rfft, a dense mel
    product), same contract as `mel_frontend`."""
    window, _, _, _, fb = _on_device(
        (n_fft, win_length, n_mels, sampling_rate, f_min, f_max), prepadded.device)
    mag = framed_magnitude(prepadded.clamp(-1.0, 1.0), window, n_fft, hop_length)  # (B, T, F)
    logmel = torch.log(torch.clamp(mag @ fb, min=1.0e-5)).transpose(-1, -2)
    power = mag * mag
    p_sum = power.sum(-1)
    return logmel, torch.sqrt(p_sum), p_sum, torch.log(power + KURTOSIS_EPS).sum(-1)


def _checked(x: torch.Tensor, n_fft: int, hop_length: int, win_length: int, n_mels: int):
    if x.dim() != 2:
        raise ValueError(f"mel_frontend takes prepadded audio as (B, L); got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"mel_frontend kernel takes float32 audio; got {x.dtype}")
    if n_fft & (n_fft - 1) or not MIN_N_FFT <= n_fft <= MAX_N_FFT:
        raise ValueError(f"mel_frontend kernel takes n_fft a power of two in "
                         f"[{MIN_N_FFT}, {MAX_N_FFT}]; got {n_fft}")
    if not 0 < win_length <= n_fft or hop_length <= 0 or n_mels <= 0:
        raise ValueError(f"mel_frontend: win_length {win_length} (<= n_fft {n_fft}), "
                         f"hop {hop_length} and n_mels {n_mels} must be positive")
    B, L = x.shape
    if L < n_fft or not 0 < B <= _MAX_BATCH:
        raise ValueError(f"mel_frontend kernel takes 1 <= B <= {_MAX_BATCH} clips of at "
                         f"least n_fft = {n_fft} samples; got {tuple(x.shape)}")
    if x.device.type != "cuda":
        raise ValueError(f"mel_frontend: unsupported device {x.device}")


def _load_library() -> ctypes.CDLL:
    # 9 pointers, 5 ints (batch, length, n_fft, hop, n_mels), stream
    return load_library("mel_frontend", {
        "mel_frontend_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]})


def mel_frontend(prepadded: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                 win_length: int = 1024, n_mels: int = 80, sampling_rate: int = 22050,
                 f_min: float = 0.0, f_max: float = 8000.0):
    """Log-mel (B, n_mels, T) and the per-frame energy, power sum and
    log-power sum (B, T) of reflect-pre-padded clips (B, L). CPU tensors take
    `mel_frontend_reference`; CUDA tensors launch the kernel or raise."""
    args = (n_fft, hop_length, win_length, n_mels, sampling_rate, f_min, f_max)
    if prepadded.device.type == "cpu":
        return mel_frontend_reference(prepadded, *args)
    check_inference("mel_frontend", prepadded)
    _checked(prepadded, n_fft, hop_length, win_length, n_mels)
    x = prepadded.contiguous()
    B, L = x.shape
    T = (L - n_fft) // hop_length + 1
    window, twiddle, index, weights, _ = _on_device(
        (n_fft, win_length, n_mels, sampling_rate, f_min, f_max), x.device)
    logmel = torch.empty(B, T, n_mels, dtype=torch.float32, device=x.device)
    energy, p_sum, logp_sum = torch.empty(3, B, T, dtype=torch.float32, device=x.device)
    lib = _load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.mel_frontend_fwd(
            x.data_ptr(), twiddle.data_ptr(), window.data_ptr(), index.data_ptr(),
            weights.data_ptr(), logmel.data_ptr(), energy.data_ptr(), p_sum.data_ptr(),
            logp_sum.data_ptr(), B, L, n_fft, hop_length, n_mels, stream)
    check_launch("mel_frontend", err)
    mel_frontend.launches += 1
    return logmel.transpose(1, 2), energy, p_sum, logp_sum


mel_frontend.launches = 0


def fused_logmel_energy(prepadded: torch.Tensor, n_fft: int = 1024, hop_length: int = 256,
                        win_length: int = 1024, n_mels: int = 80, sampling_rate: int = 22050,
                        f_min: float = 0.0, f_max: float = 8000.0):
    """(logmel (B, n_mels, T), energy (B, T)) through `mel_frontend`; the
    counterpart of `pallas_logmel_energy` and of `ops/stft.py::
    logmel_and_energy` on the un-padded clips."""
    logmel, energy, _, _ = mel_frontend(prepadded, n_fft, hop_length, win_length, n_mels,
                                        sampling_rate, f_min, f_max)
    return logmel, energy


def fused_clip_features(prepadded: torch.Tensor, durations: torch.Tensor, max_chars: int,
                        n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024,
                        n_mels: int = 80, sampling_rate: int = 22050, f_min: float = 0.0,
                        f_max: float = 8000.0):
    """(logmel (B, n_mels, T), char_energy, kurtosis (B, max_chars)) through
    `mel_frontend` and `char_stats_from_frame_sums`; the counterpart of
    `pallas_clip_features` and of `ops/stft.py::clip_features`.
    durations: (B, max_chars) zero-padded frame counts."""
    logmel, energy, p_sum, logp_sum = mel_frontend(
        prepadded, n_fft, hop_length, win_length, n_mels, sampling_rate, f_min, f_max)
    char_energy, kurt = char_stats_from_frame_sums(
        energy, p_sum, logp_sum, durations, max_chars=max_chars, n_freqs=n_fft // 2 + 1)
    return logmel, char_energy, kurt
