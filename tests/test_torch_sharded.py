"""Serving and the feature pass over several devices, on two (or three) CPU
"devices", against one.

- `Synthesizer(devices=["cpu", "cpu"])` on the demo checkpoint against one
  device, at B 4 and at B 3 (padded to 4), and over three devices at B 4
  (padded to 6): equal durations and mel lengths; each device's rows bit
  for bit what one device gives for the same rows as a batch; against the
  whole batch on one device, mel, energy and waveform within 2e-6 of their
  max (the CPU's GEMMs sum in another order at another batch size: 1.4e-6
  at most here); `synthesize` runs its one item unpadded on the first
  device, bit for bit; `serving_devices` resolves None and lists.
- `extract_features(devices=["cpu", "cpu"])` (B3's plain version on each
  share) against one device, bit for bit, and against the JAX package's
  `_sharded_pallas_features` on a two-device CPU mesh (the Pallas kernel in
  interpret mode, as `tests/test_preprocess_sharded_dsp.py` runs it): log-mel
  within 1e-4 absolute, char energy and kurtosis within 1e-4 relative.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu_torch.data.features import extract_features, pad_batch
from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer, serving_devices

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples"))
import export_demo_for_torch as export  # noqa: E402

TEXTS = ["パンパン", "バウバウ", "ドン", "チパチパ"]
MAX_CHARS = 48


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _synth(devices):
    return Synthesizer.from_checkpoint(export.port_demo_config(), str(export.OUT / "acoustic.npz"),
                                       str(export.OUT / "vocoder.npz"), device="cpu",
                                       devices=devices)


@pytest.fixture(scope="module")
def one():
    return _synth(None)


@pytest.mark.parametrize("n_dev,batch", [(2, 4), (2, 3), (3, 4)], ids=["2x4", "2x3", "3x4"])
def test_sharded_synthesizer_equals_one_device(one, n_dev, batch):
    sharded = _synth(["cpu"] * n_dev)
    texts = TEXTS[:batch]
    types = ["drum", "bell", "drum", "bell"][:batch]
    b_pad = max(1, 1 << (batch - 1).bit_length())
    assert sharded.batch_signature(texts)[0] == -(-b_pad // n_dev) * n_dev
    got = sharded.synthesize_batch(texts, types, e_control=[1.0, 1.2, 0.9, 1.0][:batch])
    want = one.synthesize_batch(texts, types, e_control=[1.0, 1.2, 0.9, 1.0][:batch])
    for g, w in zip(got, want):
        assert g.mel_len == w.mel_len
        np.testing.assert_array_equal(g.durations, w.durations)
        for k in ("mel", "wav", "energy"):
            a, b = getattr(g, k), getattr(w, k)
            assert np.abs(a - b).max() <= 2e-6 * np.abs(b).max(), k
    if (n_dev, batch) == (2, 4):        # each device's two rows, as one device runs them
        halves = (one.synthesize_batch(texts[:2], types[:2], e_control=[1.0, 1.2])
                  + one.synthesize_batch(texts[2:], types[2:], e_control=[0.9, 1.0]))
        for g, h in zip(got, halves):
            assert np.array_equal(g.mel, h.mel) and np.array_equal(g.wav, h.wav)
    single, ref = sharded.synthesize("パンパン", "drum"), one.synthesize("パンパン", "drum")
    assert np.array_equal(single.wav, ref.wav) and np.array_equal(single.mel, ref.mel)


def test_serving_devices():
    cpu = torch.device("cpu")
    assert serving_devices("cpu") == [cpu] == serving_devices("cpu", None)
    assert serving_devices("cpu", ["cpu", "cpu"]) == [cpu, cpu]
    with pytest.raises(ValueError, match="auto"):
        serving_devices("cpu", "all")


def _clips(n, seed=0, sr=22050):
    rng = np.random.default_rng(seed)
    audios, durs = [], []
    for i in range(n):
        length = sr // 2 + 256 * (i % 5)
        audios.append(rng.uniform(-0.5, 0.5, length).astype(np.float32))
        t = length // 256 + 1
        c = 2 + i % 3
        d = np.full(c, t // c, np.int32)
        d[-1] = t - d[:-1].sum()
        durs.append(d)
    return audios, durs


@pytest.mark.parametrize("n", [4, 3], ids=["even", "padded"])
def test_feature_pass_over_two_devices(n):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from visual_onoma_to_wave_tpu.data.preprocess import _sharded_pallas_features

    audios, durs = _clips(n)
    one = extract_features(audios, durs, device="cpu", max_chars=MAX_CHARS)
    two = extract_features(audios, durs, device="cpu", max_chars=MAX_CHARS, devices=["cpu", "cpu"])
    assert two[0].shape[0] == -(-n // 2) * 2
    for a, b in zip(one, two):
        assert torch.equal(a, b[:n])
    batch, dur = pad_batch(audios, durs, n_fft=1024, hop_length=256, max_chars=MAX_CHARS)
    b_pad = two[0].shape[0]
    batch = np.pad(batch, ((0, b_pad - n), (0, 0)))
    dur = np.pad(dur, ((0, b_pad - n), (0, 0)))
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    want = _sharded_pallas_features(mesh, jnp.asarray(batch), jnp.asarray(dur), MAX_CHARS,
                                    1024, 256, 1024, 80, 22050, 0.0, 8000.0)
    logmel, energy, kurt = (np.asarray(w)[:n] for w in want)
    for i, d in enumerate(durs):
        frames, c = int(d.sum()), len(d)
        np.testing.assert_allclose(two[0][i, :, :frames].numpy(), logmel[i, :, :frames],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(two[1][i, :c].numpy(), energy[i, :c], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(two[2][i, :c].numpy(), kurt[i, :c], rtol=1e-4, atol=1e-6)


def test_preprocessor_takes_a_device_list(tmp_path):
    from visual_onoma_to_wave_tpu_torch.config import Config
    from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor

    cfg = Config()
    cfg = cfg.replace(path=cfg.path.__class__(formatted=str(tmp_path / "f"),
                                              preprocessed=str(tmp_path / "p"), font=""))
    assert Preprocessor(cfg, device="cpu").devices == [torch.device("cpu")]
    pre = Preprocessor(cfg, device="cpu", devices=["cpu", "cpu"])
    audios, durs = _clips(3, seed=2)
    out = pre._features_finalize(pre._features_dispatch(audios, durs), durs)
    ref = Preprocessor(cfg, device="cpu")
    want = ref._features_finalize(ref._features_dispatch(audios, durs), durs)
    assert len(out) == 3
    for got, w in zip(out, want):
        for a, b in zip(got, w):
            assert np.array_equal(a, b)
