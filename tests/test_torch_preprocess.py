"""Corpus preprocessing through the port against the JAX package's, on the CPU.

One formatted corpus (`examples/train_demo_artifacts.py::build_corpus`, 8
clips per class, then the reference `cli format` and `prepare-tg`) goes
through the reference `Preprocessor` (JAX on the CPU, its jnp DSP path) and
through the port's `Preprocessor(device="cpu")` (the mel frontend's plain
version, the config loaded by the port's own loader) into two directories.
The port's host passes are copies of the reference's, so every host
artifact must be identical; the features come from two fp32 FFTs.
Bounds, with the largest differences measured:

- log-mel: the JAX package's own kernel-vs-jnp bound, 2e-3 + 1e-4 |ref|,
  and MAE < 1e-3. Measured: MAE 1.6e-5, max 2.5e-3 at a bin of -11.30,
  just above the log(1e-5) = -11.51 clamp, where the decaying bell tones
  leave fp32 spectra at their rounding noise (chip_smoke phase 7 finds the
  plain fp32 path on the card up to 3.2e-2 off float64 at such bins);
- normalised energy and kurtosis 1e-4 absolute (measured 4.3e-7 and
  2.5e-5); in stats.json the normalised min and max 1e-4 absolute (1.7e-5)
  and the raw mean and std 1e-5 relative (4.1e-7).

Also: the port's `cli preprocess --device cpu`, the host batching helper's
bucket lengths against the reference formula, and `device="cuda"` raising
without a card.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from examples.train_demo_artifacts import build_corpus, work_config
from visual_onoma_to_wave_tpu.cli import load_config as reference_load_config
from visual_onoma_to_wave_tpu.cli import main as reference_cli
from visual_onoma_to_wave_tpu.data.preprocess import Preprocessor as ReferencePreprocessor
from visual_onoma_to_wave_tpu_torch.cli import main as port_cli
from visual_onoma_to_wave_tpu_torch.config import load_config
from visual_onoma_to_wave_tpu_torch.data.features import bucket_length, pad_batch
from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor

MEL_ATOL, MEL_RTOL, MEL_MAE = 2e-3, 1e-4, 1e-3
NORM_ATOL, STATS_RTOL = 1e-4, 1e-5
HOST_ARTIFACTS = ("duration", "image")
METADATA = ("train.txt", "val.txt", "test.txt", "audiotype.json", "label_width.json",
            "visual_text.json", "symbols.json")


def _config_file(root: pathlib.Path, ono_root, preprocessed: pathlib.Path) -> str:
    cfg = work_config(root, ono_root, steps=1)
    cfg["path"]["preprocessed"] = str(preprocessed)
    path = root / f"{preprocessed.name}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(reference tree, port tree, corpus root, ono root): the formatted
    demo corpus preprocessed by both packages."""
    root = tmp_path_factory.mktemp("torch_preprocess")
    raw_root, ono_root = build_corpus(root, n_per_class=8)
    cfg = _config_file(root, ono_root, root / "reference")
    reference_cli(["format", cfg, str(raw_root)])
    reference_cli(["prepare-tg", cfg])
    ReferencePreprocessor(reference_load_config(cfg), num_workers=2).build(verbose=False)
    port_cfg = _config_file(root, ono_root, root / "port")
    Preprocessor(load_config(port_cfg), num_workers=2, device="cpu").build(verbose=False)
    return root / "reference", root / "port", root, ono_root


def _files(tree: pathlib.Path) -> set[str]:
    return {str(p.relative_to(tree)) for p in tree.rglob("*") if p.is_file()}


def test_same_files_and_identical_host_artifacts(trees):
    ref, port, _, _ = trees
    files = _files(ref)
    assert files == _files(port)
    assert any(f.startswith("mel/") for f in files)
    assert any("repeat" in f for f in files)          # pass 3 ran
    for f in sorted(files):
        if f.split("/")[0] in HOST_ARTIFACTS or f in METADATA:
            assert (ref / f).read_bytes() == (port / f).read_bytes(), f


def test_mels_within_the_jax_kernel_bound(trees):
    ref, port, _, _ = trees
    mels = sorted((ref / "mel").rglob("*.npy"))
    assert mels
    errs = []
    for f in mels:
        a, b = np.load(port / f.relative_to(ref)), np.load(f)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, f
        np.testing.assert_allclose(a, b, atol=MEL_ATOL, rtol=MEL_RTOL, err_msg=str(f))
        errs.append(np.abs(a - b))
    assert float(np.concatenate([e.ravel() for e in errs]).mean()) < MEL_MAE


def test_normalised_energy_kurtosis_and_stats(trees):
    ref, port, _, _ = trees
    for name in ("energy", "kurtosis"):
        files = sorted((ref / name).rglob("*.npy"))
        assert files
        for f in files:
            np.testing.assert_allclose(np.load(port / f.relative_to(ref)), np.load(f),
                                       atol=NORM_ATOL, err_msg=str(f))
    got = json.loads((port / "stats.json").read_text())
    want = json.loads((ref / "stats.json").read_text())
    assert got.keys() == want.keys() == {"energy", "kurtosis"}
    for name in want:   # [min, max] of the normalised values, then [mean, std] of the raw
        np.testing.assert_allclose(got[name][:2], want[name][:2], atol=NORM_ATOL, err_msg=name)
        np.testing.assert_allclose(got[name][2:], want[name][2:], rtol=STATS_RTOL, err_msg=name)


def test_cli_preprocess_on_the_cpu(trees, capsys):
    _, port, root, ono_root = trees
    cfg = _config_file(root, ono_root, root / "port_cli")
    port_cli(["preprocess", cfg, "--device", "cpu", "--num-workers", "2"])
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["labels"] == ["bell", "drum"] and result["hours"] > 0
    out = root / "port_cli"
    assert _files(out) == _files(port)
    for f in sorted((port / "mel").rglob("*.npy")):
        np.testing.assert_array_equal(np.load(out / f.relative_to(port)), np.load(f))


def _reference_bucket(max_len: int, n_fft: int, hop: int) -> int:
    """visual_onoma_to_wave_tpu/data/preprocess.py:242-244, verbatim."""
    units = (max_len - n_fft + 32 * hop - 1) // (32 * hop)
    units = 1 << max(0, int(np.ceil(np.log2(max(units, 1)))))
    return n_fft + units * 32 * hop


@pytest.mark.parametrize("n_fft,hop", [(1024, 256), (512, 128)])
def test_bucket_length_matches_the_reference(n_fft, hop):
    step = 32 * hop
    edges = [n_fft + 1, n_fft + step // 2]                      # the shortest clips
    for k in range(6):
        exact = n_fft + (1 << k) * step
        edges += [exact - 1, exact, exact + 1]                  # a power exactly, one over
    for max_len in edges:
        assert bucket_length(max_len, n_fft, hop) == _reference_bucket(max_len, n_fft, hop)
        assert bucket_length(max_len, n_fft, hop) >= max_len


def test_pad_batch_reflects_each_clip_then_zero_pads():
    rng = np.random.default_rng(0)
    audios = [rng.uniform(-1.5, 1.5, n).astype(np.float32) for n in (600, 9000, 4000)]
    durations = [np.array([2, 1], np.int32), np.array([20, 0, 15], np.int32),
                 np.array([16], np.int32)]
    batch, dur = pad_batch(audios, durations, n_fft=1024, hop_length=256, max_chars=48)
    assert batch.shape == (3, _reference_bucket(9000 + 1024, 1024, 256))
    assert batch.dtype == np.float32 and dur.shape == (3, 48) and dur.dtype == np.int32
    for i, (a, d) in enumerate(zip(audios, durations)):
        pre = np.pad(np.clip(a, -1, 1), 512, mode="reflect")
        assert np.array_equal(batch[i, :len(pre)], pre) and not batch[i, len(pre):].any()
        assert np.array_equal(dur[i, :len(d)], d) and not dur[i, len(d):].any()


def test_cuda_device_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: device='cuda' is valid here")
    cfg = load_config(_config_file(tmp_path, tmp_path / "onoma", tmp_path / "out"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Preprocessor(cfg, device="cuda")
