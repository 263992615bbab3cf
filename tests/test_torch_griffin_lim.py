"""`ops/stft.py::griffin_lim` of the port against the JAX package's, on the CPU.

Both start from the same initial phase: JAX's draw from its key
(`jax.random.uniform(key, (F, T), minval=-pi, maxval=pi)`, what its
`griffin_lim` draws) is passed to the port as numpy `angles`. After 30
iterations the waveforms agree within 1e-4 of their max, on a tone and on
random magnitudes. JAX's own tone test (tests/test_stft_parity.py) is
repeated on the port with the port's generator's draw.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu.ops import stft as jstft
from visual_onoma_to_wave_tpu_torch.ops import stft as tstft

SR, N_FFT, HOP = 22050, 1024, 256


def _tone_magnitudes() -> tuple[np.ndarray, np.ndarray]:
    t = np.arange(4 * 1024) / SR
    sig = (0.6 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    mag = tstft.magnitude_spectrogram(torch.from_numpy(sig), torch.from_numpy(
        tstft.hann_window(N_FFT)), N_FFT, HOP, N_FFT)
    return sig, mag.numpy()


@pytest.mark.parametrize("source", ["tone", "random"])
def test_griffin_lim_matches_jax_from_the_same_angles(source):
    window = tstft.hann_window(N_FFT)
    if source == "tone":
        mag = _tone_magnitudes()[1]
    else:
        mag = np.abs(np.random.default_rng(0).normal(size=(N_FFT // 2 + 1, 24))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    angles = np.array(jax.random.uniform(key, mag.shape, minval=-np.pi, maxval=np.pi))
    want = np.asarray(jstft.griffin_lim(jnp.asarray(mag), jnp.asarray(window), key, N_FFT, HOP,
                                        N_FFT, n_iters=30))
    got = tstft.griffin_lim(torch.from_numpy(mag), torch.from_numpy(window), N_FFT, HOP, N_FFT,
                            n_iters=30, angles=torch.from_numpy(angles)).numpy()
    assert got.shape == want.shape == ((mag.shape[1] - 1) * HOP,)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_griffin_lim_reconstructs_tone():
    """JAX's tone test on the port: the reconstruction's re-analysed
    magnitude within 15% (relative L2) of the target's."""
    sig, mag = _tone_magnitudes()
    window = torch.from_numpy(tstft.hann_window(N_FFT))
    rec = tstft.griffin_lim(torch.from_numpy(mag), window, N_FFT, HOP, N_FFT, n_iters=40,
                            generator=torch.Generator().manual_seed(0))
    assert rec.shape[0] >= sig.shape[0] - HOP
    mag2 = tstft.magnitude_spectrogram(rec[:sig.shape[0]], window, N_FFT, HOP, N_FFT).numpy()
    a, b = mag[:, 2:-2], mag2[:, 2:-2]
    assert np.linalg.norm(a - b) / np.linalg.norm(a) < 0.15


def test_griffin_lim_draws_its_angles_from_the_generator():
    mag = torch.from_numpy(_tone_magnitudes()[1])
    window = torch.from_numpy(tstft.hann_window(N_FFT))
    one = tstft.griffin_lim(mag, window, N_FFT, HOP, n_iters=2,
                            generator=torch.Generator().manual_seed(5))
    again = tstft.griffin_lim(mag, window, N_FFT, HOP, n_iters=2,
                              generator=torch.Generator().manual_seed(5))
    other = tstft.griffin_lim(mag, window, N_FFT, HOP, n_iters=2,
                              generator=torch.Generator().manual_seed(6))
    assert torch.equal(one, again) and not torch.equal(one, other)
