"""The port's DSP (`ops/stft.py`) and mel frontend (`ops/mel.py`) against the JAX package.

Same numpy-seeded inputs through the JAX function and its port, on the CPU;
the JAX Pallas kernel runs in interpret mode, as its own tests run it.
Both sides are fp32 (FFTs, or the JAX kernel's DFT product), so they differ
by rounding only. Bounds, with the largest errors measured on the CPU:

- window and filterbank 1e-7 (measured 0: the same float64 construction);
- magnitude spectra 1e-4 + 1e-5 |ref| (measured 5.7e-6 absolute), log-mels
  1e-4 absolute (1.4e-6), frame and char energies 1e-5 relative (1.5e-7),
  kurtosis 1e-4 + 1e-4 |ref| (1.3e-5 absolute);
- the mel frontend against the JAX kernel over the case grid of
  tests/test_pallas_mel.py: chip_smoke's `check_mel_frontend` and
  `check_clip_features` bounds, the same as the kernel's on the card. Log-mel
  1e-4 absolute (5.3e-6) except full_scale, where the JAX kernel's DFT
  product is 1.7e-3 off float64 (the port's FFT 6.0e-4) and the bound is the
  JAX package's own (2e-3 + 1e-4 |ref|; measured 2.2e-3 at |ref| 10.2);
  MAE < 1e-3 everywhere (2.5e-5); frame sums 1e-5 relative (7.9e-7); the
  log-power sum 1e-3 per bin (full_scale 6.1e-4); kurtosis 1e-4 + 1e-4 |ref|
  (full_scale 3.2e-4 at 97.6). The kurtosis of an all-silent character may
  be NaN on either side (`chip_smoke.kurtosis_mismatch`: the JAX kernel gives
  NaN there, the port 1.00003).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import visual_onoma_to_wave_tpu.ops.stft as jstft
import visual_onoma_to_wave_tpu_torch.ops.stft as tstft
from visual_onoma_to_wave_tpu.ops.pallas_mel import _run_mel_kernel, pallas_clip_features
from visual_onoma_to_wave_tpu_torch.ops.mel import (
    fused_clip_features,
    fused_logmel_energy,
    mel_frontend_reference,
)

N_FFT, HOP, SR, N_MELS = 1024, 256, 22050, 80
MAX_CHARS = 8
LOGMEL_ATOL, ENERGY_RTOL = 1e-4, 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, atol=0.0, rtol=0.0):
    np.testing.assert_allclose(_np(got), _np(ref), atol=atol, rtol=rtol)


def _window_fb(win_length=N_FFT):
    return (jstft.hann_window(win_length),
            jstft.melscale_fbanks(N_FFT // 2 + 1, 0.0, 8000.0, N_MELS, SR))


def _audio(batched: bool, seed: int = 0, samples: int = 3 * HOP * 11 + 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.9, 0.9, (3, samples) if batched else (samples,)).astype(np.float32)


def _durations(batched: bool, n_frames: int) -> np.ndarray:
    """Zeros inside and padding after the last character; the last few
    frames belong to no character."""
    rows = np.zeros((3, MAX_CHARS), np.int32)
    rows[0, :5] = [6, 0, 9, 11, n_frames - 30]
    rows[1, :2] = [n_frames - 4, 3]
    rows[2, :3] = [0, 1, n_frames // 2]
    return rows if batched else rows[0]


@pytest.mark.parametrize("what", ["hann_1024", "hann_800", "fb_default", "fb_512_64_11025"])
def test_window_and_filterbank_match_jax(what):
    if what.startswith("hann"):
        n = int(what.split("_")[1])
        got, ref = tstft.hann_window(n), jstft.hann_window(n)
    elif what == "fb_default":
        got = tstft.melscale_fbanks(N_FFT // 2 + 1, 0.0, 8000.0, N_MELS, SR)
        ref = jstft.melscale_fbanks(N_FFT // 2 + 1, 0.0, 8000.0, N_MELS, SR)
    else:
        got = tstft.melscale_fbanks(257, 20.0, 11025.0, 64, SR)
        ref = jstft.melscale_fbanks(257, 20.0, 11025.0, 64, SR)
    assert got.dtype == ref.dtype == np.float32 and got.shape == ref.shape
    _close(got, ref, atol=1e-7)


@pytest.mark.parametrize("batched", [False, True], ids=["clip", "batch"])
def test_spectra_match_jax(batched):
    audio = _audio(batched)
    padded = np.asarray(jstft._reflect_pad_1d(jnp.asarray(audio), N_FFT // 2))
    assert np.array_equal(tstft.reflect_pad(_t(audio), N_FFT // 2).numpy(), padded)
    assert np.array_equal(tstft.frame_signal(_t(padded), N_FFT, HOP).numpy(),
                          np.asarray(jstft.frame_signal(jnp.asarray(padded), N_FFT, HOP)))
    for win in (N_FFT, 800):
        window, fb = _window_fb(win)
        mag = tstft.magnitude_spectrogram(_t(audio), _t(window), N_FFT, HOP, win)
        ref = jstft.magnitude_spectrogram(jnp.asarray(audio), jnp.asarray(window), N_FFT, HOP,
                                          win)
        assert mag.shape == ref.shape
        _close(mag, ref, atol=1e-4, rtol=ENERGY_RTOL)
        mel, energy = tstft.logmel_and_energy(_t(audio), _t(window), _t(fb), N_FFT, HOP, win)
        ref_mel, ref_energy = jstft.logmel_and_energy(jnp.asarray(audio), jnp.asarray(window),
                                                      jnp.asarray(fb), N_FFT, HOP, win)
        _close(mel, ref_mel, atol=LOGMEL_ATOL)
        _close(energy, ref_energy, rtol=ENERGY_RTOL)


@pytest.mark.parametrize("batched", [False, True], ids=["clip", "batch"])
def test_char_reductions_match_jax(batched):
    audio = _audio(batched, seed=1)
    window, _ = _window_fb()
    n_frames = audio.shape[-1] // HOP + 1
    durs = _durations(batched, n_frames)
    rng = np.random.default_rng(2)
    shape = audio.shape[:-1] + (n_frames,)
    sums = [rng.uniform(0.1, 5.0, shape).astype(np.float32) for _ in range(2)]
    sums.append(rng.uniform(-9000.0, -100.0, shape).astype(np.float32))

    def jax_fn(fn, *args):
        return jax.vmap(fn)(*args) if batched else fn(*args)

    got = tstft.char_stats_from_frame_sums(*map(_t, sums), _t(durs), max_chars=MAX_CHARS,
                                           n_freqs=N_FFT // 2 + 1)
    ref = jax_fn(lambda e, p, lp, d: jstft.char_stats_from_frame_sums(
        e, p, lp, d, max_chars=MAX_CHARS, n_freqs=N_FFT // 2 + 1), *map(jnp.asarray, sums),
        jnp.asarray(durs))
    _close(got[0], ref[0], rtol=ENERGY_RTOL)
    _close(got[1], ref[1], atol=1e-4, rtol=1e-4)
    assert (got[0].numpy()[durs == 0] == 0).all() and (got[1].numpy()[durs == 0] == 0).all()

    energy = tstft.char_level_energy(_t(sums[0]), _t(durs), MAX_CHARS)
    _close(energy, jax_fn(lambda e, d: jstft.char_level_energy(e, d, MAX_CHARS),
                          jnp.asarray(sums[0]), jnp.asarray(durs)), rtol=ENERGY_RTOL)

    kurt = tstft.spectral_kurtosis(_t(audio), _t(durs), _t(window), MAX_CHARS, N_FFT, HOP, N_FFT)
    ref = jax_fn(lambda a, d: jstft.spectral_kurtosis(a, d, jnp.asarray(window), MAX_CHARS, N_FFT,
                                                      HOP, N_FFT),
                 jnp.asarray(audio), jnp.asarray(durs))
    _close(kurt, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("batched", [False, True], ids=["clip", "batch"])
def test_clip_features_match_jax(batched):
    audio = _audio(batched, seed=3)
    window, fb = _window_fb()
    padded = np.asarray(jstft._reflect_pad_1d(jnp.asarray(audio), N_FFT // 2))
    padded = np.pad(padded, [(0, 0)] * (padded.ndim - 1) + [(0, 3 * HOP)])   # bucket zeros
    durs = _durations(batched, audio.shape[-1] // HOP + 1)
    got = tstft.clip_features(_t(padded), _t(durs), _t(window), _t(fb), MAX_CHARS, N_FFT, HOP,
                              N_FFT)
    ref = jstft.clip_features(jnp.asarray(padded), jnp.asarray(durs), jnp.asarray(window),
                              jnp.asarray(fb), MAX_CHARS, N_FFT, HOP, N_FFT)
    assert got[0].shape == ref[0].shape
    _close(got[0], ref[0], atol=LOGMEL_ATOL)
    _close(got[1], ref[1], rtol=ENERGY_RTOL)
    _close(got[2], ref[2], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("batched", [False, True], ids=["clip", "batch"])
def test_mel_pipeline_matches_jax(batched):
    audio = _audio(batched, seed=4)
    durs = _durations(batched, audio.shape[-1] // HOP + 1)
    got, ref = tstft.MelPipeline(), jstft.MelPipeline()
    for a, b in zip(got(_t(audio)), ref(jnp.asarray(audio))):
        _close(a, b, atol=LOGMEL_ATOL, rtol=ENERGY_RTOL)
    if batched:
        ref_k = jax.vmap(lambda a, d: ref.kurtosis(a, d, MAX_CHARS))(jnp.asarray(audio),
                                                                    jnp.asarray(durs))
    else:
        ref_k = ref.kurtosis(jnp.asarray(audio), jnp.asarray(durs), MAX_CHARS)
    _close(got.kurtosis(_t(audio), _t(durs), MAX_CHARS), ref_k, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name,prepadded,win",
                         [pytest.param(*case, id=case[0]) for case in chip_smoke.mel_cases()])
def test_mel_frontend_matches_the_jax_kernel(name, prepadded, win):
    out, n_frames = _run_mel_kernel(jnp.asarray(prepadded), N_FFT, HOP, win, N_MELS, SR, 0.0,
                                    8000.0, 128, True)
    out = np.asarray(out)[:, :n_frames]
    ref = (out[..., :N_MELS].transpose(0, 2, 1), out[..., N_MELS], out[..., N_MELS + 1],
           out[..., N_MELS + 2])
    got = [t.numpy() for t in mel_frontend_reference(_t(prepadded), win_length=win)]
    loose = name == "full_scale"
    chip_smoke.check_mel_frontend(name, got, ref, loose)

    durs = chip_smoke.mel_durations(prepadded.shape[0], n_frames, MAX_CHARS)
    ref = pallas_clip_features(jnp.asarray(prepadded), jnp.asarray(durs), MAX_CHARS, N_FFT, HOP,
                               win, sampling_rate=SR, interpret=True)
    got = fused_clip_features(_t(prepadded), _t(durs), MAX_CHARS, win_length=win)
    chip_smoke.check_clip_features(name, [t.numpy() for t in got], [np.asarray(r) for r in ref],
                                   loose)


def test_short_window_matches_logmel_and_energy():
    """win_length 800 < n_fft: the JAX `clip_features` cannot run it (its
    window is not padded, stft.py:242); the port pads it, as the TPU kernel
    and `magnitude_spectrogram` do. Held against `logmel_and_energy`."""
    audio = np.random.default_rng(4).uniform(-1, 1, (2, 4096)).astype(np.float32)
    window, fb = _window_fb(800)
    ref_mel, ref_energy = jstft.logmel_and_energy(jnp.asarray(audio), jnp.asarray(window),
                                                  jnp.asarray(fb), N_FFT, HOP, 800)
    padded = tstft.reflect_pad(_t(audio), N_FFT // 2)
    mel, energy = fused_logmel_energy(padded, win_length=800)
    _close(mel, ref_mel, atol=LOGMEL_ATOL)
    _close(energy, ref_energy, rtol=ENERGY_RTOL)
    mel, _, _ = tstft.clip_features(padded, _t(np.zeros((2, 4), np.int32)), _t(window), _t(fb), 4,
                                    N_FFT, HOP, 800)
    _close(mel, ref_mel, atol=LOGMEL_ATOL)
