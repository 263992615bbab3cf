"""Audio DSP in plain PyTorch: STFT, mel spectrogram, energy, spectral kurtosis.

Port of visual_onoma_to_wave_tpu/ops/stft.py (the torchaudio chain of the
reference preprocessor: Spectrogram(n_fft 1024, win 1024, hop 256, power 1,
center) -> MelScale(80, slaney norm, HTK scale) -> log(clamp(., 1e-5)), per-frame
L2 energy, per-character spectral kurtosis). The window and the filterbank
are numpy constants built in float64 and rounded once to float32; the FFT is
`torch.fft.rfft` in fp32. These functions are the plain versions that the
fused mel kernel (`ops/mel.py`, `csrc/mel_frontend.cu`) is held against.

One deliberate difference from the JAX module: `clip_features` zero-pads a
window shorter than n_fft to the centre, as `magnitude_spectrogram` and the
TPU kernel do (visual_onoma_to_wave_tpu/ops/pallas_mel.py:68-70); the JAX
`clip_features` (stft.py:242) multiplies n_fft-wide frames by the unpadded
window and so cannot run win_length < n_fft.

Shapes follow the JAX module: audio (..., samples), spectrograms
(..., F, T), mels (..., n_mels, T); the char-level reductions take durations
(..., max_chars) and work batched or per clip. `griffin_lim` is the
reference's legacy inverse path (JAX stft.py:309); no kernel lies under it,
so its `torch.fft` calls are the port's own implementation.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

KURTOSIS_EPS = 1e-8


# ---------------------------------------------------------------------------
# window + mel filterbank (host, float64 -> float32)
# ---------------------------------------------------------------------------

def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window, identical to torch.hann_window(win_length)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _hz_to_mel_htk(f) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def melscale_fbanks(n_freqs: int, f_min: float, f_max: float, n_mels: int,
                    sample_rate: int, norm: str | None = "slaney") -> np.ndarray:
    """(n_freqs, n_mels) triangular filters on the HTK mel scale with slaney
    area normalisation (torchaudio melscale_fbanks(norm="slaney",
    mel_scale="htk"))."""
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(_hz_to_mel_htk(f_min), _hz_to_mel_htk(f_max), n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


# ---------------------------------------------------------------------------
# framing and spectra
# ---------------------------------------------------------------------------

def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect padding of the last axis (torch.stft center=True)."""
    shape = x.shape
    flat = F.pad(x.reshape(-1, 1, shape[-1]), (pad, pad), mode="reflect")
    return flat.reshape(*shape[:-1], shape[-1] + 2 * pad)


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """(..., samples) -> (..., n_frames, n_fft) overlapping frames,
    n_frames = (samples - n_fft) // hop + 1 (x is already centre-padded)."""
    return x.unfold(-1, n_fft, hop_length)


def pad_window(window: torch.Tensor, n_fft: int) -> torch.Tensor:
    """A window shorter than n_fft zero-padded to the centre of n_fft
    (torch.stft's rule, and the TPU kernel's)."""
    win_length = window.shape[-1]
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def framed_magnitude(prepadded: torch.Tensor, window: torch.Tensor, n_fft: int,
                     hop_length: int) -> torch.Tensor:
    """|rfft| of the windowed frames of a centre-padded signal: (..., T, F)."""
    frames = frame_signal(prepadded, n_fft, hop_length) * pad_window(window, n_fft)
    return torch.fft.rfft(frames, n=n_fft, dim=-1).abs()


def magnitude_spectrogram(audio: torch.Tensor, window: torch.Tensor, n_fft: int = 1024,
                          hop_length: int = 256, win_length: int = 1024) -> torch.Tensor:
    """Magnitude STFT (torchaudio Spectrogram(power=1, center=True)):
    (..., samples) -> (..., n_fft // 2 + 1, samples // hop + 1)."""
    del win_length  # the window's own length
    padded = reflect_pad(audio, n_fft // 2)
    return framed_magnitude(padded, window, n_fft, hop_length).transpose(-1, -2)


def logmel_and_energy(audio: torch.Tensor, window: torch.Tensor, mel_fb: torch.Tensor,
                      n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024):
    """log(max(fb^T |STFT|, 1e-5)) (..., n_mels, T) and the per-frame L2
    energy of |STFT| (..., T), of the audio clipped to [-1, 1]."""
    mag = magnitude_spectrogram(audio.clamp(-1.0, 1.0), window, n_fft, hop_length, win_length)
    mel = torch.einsum("...ft,fm->...mt", mag, mel_fb)
    return torch.log(torch.clamp(mel, min=1.0e-5)), torch.sqrt((mag * mag).sum(-2))


def spectral_kurtosis(audio: torch.Tensor, durations: torch.Tensor, window: torch.Tensor,
                      max_chars: int, n_fft: int = 1024, hop_length: int = 256,
                      win_length: int = 1024) -> torch.Tensor:
    """Per-character spectral kurtosis (log-moment estimator, see
    `char_stats_from_frame_sums`) of audio (..., samples) with zero-padded
    durations (..., max_chars); entries with duration 0 are 0."""
    mag = magnitude_spectrogram(audio.clamp(-1.0, 1.0), window, n_fft, hop_length, win_length)
    power = mag * mag
    p_sum = power.sum(-2)
    logp_sum = torch.log(power + KURTOSIS_EPS).sum(-2)
    _, kurt = char_stats_from_frame_sums(torch.zeros_like(p_sum), p_sum, logp_sum, durations,
                                         max_chars=max_chars, n_freqs=power.shape[-2])
    return kurt


def char_level_energy(energy: torch.Tensor, durations: torch.Tensor,
                      max_chars: int) -> torch.Tensor:
    """Mean frame energy per character (0 where the duration is 0)."""
    zeros = torch.zeros_like(energy)
    e, _ = char_stats_from_frame_sums(energy, zeros, zeros, durations, max_chars=max_chars,
                                      n_freqs=1)
    return e


def clip_features(prepadded_audio: torch.Tensor, durations: torch.Tensor,
                  window: torch.Tensor, mel_fb: torch.Tensor, max_chars: int,
                  n_fft: int = 1024, hop_length: int = 256, win_length: int = 1024):
    """Log-mel (..., n_mels, T), char energy and kurtosis (..., max_chars)
    from one magnitude spectrogram. prepadded_audio (..., L) is reflect-padded
    by n_fft // 2 and zero-padded to its bucket; T = (L - n_fft) // hop + 1;
    frames past sum(durations) are padding for the caller to cut."""
    del win_length
    mag = framed_magnitude(prepadded_audio.clamp(-1.0, 1.0), window, n_fft,
                           hop_length).transpose(-1, -2)                   # (..., F, T)
    mel = torch.einsum("...ft,fm->...mt", mag, mel_fb)
    logmel = torch.log(torch.clamp(mel, min=1.0e-5))
    power = mag * mag
    p_sum = power.sum(-2)
    char_energy, kurt = char_stats_from_frame_sums(
        torch.sqrt(p_sum), p_sum, torch.log(power + KURTOSIS_EPS).sum(-2), durations,
        max_chars=max_chars, n_freqs=power.shape[-2])
    return logmel, char_energy, kurt


def char_stats_from_frame_sums(frame_energy: torch.Tensor, p_sum_t: torch.Tensor,
                               logp_sum_t: torch.Tensor, durations: torch.Tensor, *,
                               max_chars: int, n_freqs: int):
    """Char-level mean energy and spectral kurtosis from per-frame sums.

    frame_energy, p_sum_t, logp_sum_t: (..., T) L2 energy, sum of |S|^2 and
    sum of log(|S|^2 + eps) over frequency; durations (..., max_chars)
    zero-padded frame counts. Frame t belongs to character
    searchsorted(cumsum(durations), t, right); frames past the last
    character are dropped. Per character, over its d frames:

        gamma = log(mean P + eps) - mean log(P + eps)
        eta   = (3 - gamma + sqrt((gamma - 3)^2 + 24 gamma)) / (12 gamma)
        kurt  = (eta + 2)(eta + 3) / (eta (eta + 1) + eps)

    Returns (char_energy, kurtosis), each (..., max_chars) float32; entries
    with duration 0 are 0.
    """
    eps = KURTOSIS_EPS
    lead = frame_energy.shape[:-1]
    n_frames = frame_energy.shape[-1]
    e2 = frame_energy.reshape(-1, n_frames).float()
    p2 = p_sum_t.reshape(-1, n_frames).float()
    lp2 = logp_sum_t.reshape(-1, n_frames).float()
    dur = durations.reshape(-1, durations.shape[-1]).to(e2.device)
    bounds = torch.cumsum(dur.long(), dim=-1)
    frame_idx = torch.arange(n_frames, device=e2.device).expand(e2.shape[0], -1).contiguous()
    char_of_frame = torch.searchsorted(bounds, frame_idx, right=True)
    char_of_frame = torch.where(frame_idx < bounds[:, -1:], char_of_frame, max_chars)

    def segment_sum(v: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(v.shape[0], max_chars + 1, dtype=v.dtype, device=v.device)
        return out.scatter_add_(1, char_of_frame, v)[:, :max_chars]

    d = dur.float()
    char_energy = torch.where(d > 0, segment_sum(e2) / torch.where(d > 0, d, 1.0), 0.0)
    counts = d * n_freqs
    safe = counts > 0
    denom = torch.where(safe, counts, 1.0)
    gamma = torch.log(segment_sum(p2) / denom + eps) - segment_sum(lp2) / denom
    eta = (3.0 - gamma + torch.sqrt((gamma - 3.0) ** 2 + 24.0 * gamma)) / (12.0 * gamma)
    kurt = (eta + 2.0) * (eta + 3.0) / (eta * (eta + 1.0) + eps)
    kurt = torch.where(safe, kurt, 0.0)
    return (char_energy.reshape(*lead, max_chars), kurt.reshape(*lead, max_chars))


# ---------------------------------------------------------------------------
# convenience bundle
# ---------------------------------------------------------------------------

class MelPipeline:
    """Window and filterbank bound to one STFT/mel configuration."""

    def __init__(self, sampling_rate=22050, n_fft=1024, hop_length=256, win_length=1024,
                 n_mels=80, f_min=0.0, f_max=8000.0):
        self.sampling_rate = sampling_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.win_length = win_length
        self.n_mels = n_mels
        self.window = torch.from_numpy(hann_window(win_length))
        self.mel_fb = torch.from_numpy(
            melscale_fbanks(n_fft // 2 + 1, f_min, f_max, n_mels, sampling_rate))

    def __call__(self, audio: torch.Tensor):
        return logmel_and_energy(audio, self.window.to(audio.device),
                                 self.mel_fb.to(audio.device), self.n_fft, self.hop_length,
                                 self.win_length)

    def kurtosis(self, audio: torch.Tensor, durations: torch.Tensor, max_chars: int):
        return spectral_kurtosis(audio, durations, self.window.to(audio.device), max_chars,
                                 self.n_fft, self.hop_length, self.win_length)


# ---------------------------------------------------------------------------
# Griffin-Lim (legacy inverse path: reference audio/audio_processing.py:66-82)
# ---------------------------------------------------------------------------

def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(T, n_fft) frames -> (T - 1) * hop + n_fft samples, summed where they overlap."""
    t, n_fft = frames.shape
    total = (t - 1) * hop_length + n_fft
    return F.fold(frames.T[None], output_size=(1, total), kernel_size=(1, n_fft),
                  stride=(1, hop_length)).reshape(total)


def griffin_lim(magnitudes: torch.Tensor, window: torch.Tensor, n_fft: int = 1024,
                hop_length: int = 256, win_length: int = 1024, n_iters: int = 30,
                angles: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Griffin-Lim phase reconstruction from an (F, T) magnitude spectrogram,
    the JAX `griffin_lim`'s iteration: initial angles uniform in [-pi, pi)
    (from `generator`, or `angles` when given), then `n_iters` rounds of
    iSTFT (windowed irfft, overlap-add, divided by the summed squared window,
    centre trimmed) and STFT (reflect pad, windowed rfft, unit phase); the
    waveform of the last phase. Runs on the magnitudes' device."""
    del win_length  # the window's own length
    f, t = magnitudes.shape
    dev = magnitudes.device
    window = pad_window(window.to(dev, torch.float32), n_fft)
    if angles is None:
        angles = torch.rand((f, t), generator=generator,
                            device=generator.device if generator is not None else dev)
        angles = angles.to(dev) * (2 * np.pi) - np.pi
    phase = torch.polar(torch.ones_like(magnitudes), angles.to(dev, torch.float32))
    wsum = _overlap_add((window * window).expand(t, n_fft), hop_length)
    wsum = torch.clamp(wsum, min=1e-8)
    half = n_fft // 2

    def istft(spec: torch.Tensor) -> torch.Tensor:
        frames = torch.fft.irfft(spec.T, n=n_fft, dim=-1) * window       # (T, n_fft)
        sig = _overlap_add(frames, hop_length) / wsum
        return sig[half:sig.shape[0] - half]

    def stft_phase(sig: torch.Tensor) -> torch.Tensor:
        frames = frame_signal(reflect_pad(sig, half), n_fft, hop_length) * window
        spec = torch.fft.rfft(frames, n=n_fft, dim=-1).T[:, :t]
        return spec / torch.clamp(spec.abs(), min=1e-8)

    mags = magnitudes.to(torch.float32)
    for _ in range(n_iters):
        phase = stft_phase(istft(mags * phase))[:, :t]
    return istft(mags * phase)
