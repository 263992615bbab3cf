"""The port's `Preprocessor.build` on the card.

A formatted corpus from `benchmarks/bench_preprocess.py::build_corpus`
(256 clips over 2 labels: each label takes two 64-clip batches, so the
one-batch-in-flight pipeline runs) is preprocessed three times: with
`device="cuda"` (the mel kernel), with `device="cpu"` (its plain fp32
version) and on the CPU with pass 1 in float64 (the arbiter). The card's run
must launch the mel kernel once per batch. Its host artifacts must equal
the CPU run's byte for byte, and its features must agree with it:

- log-mel: the corpus is tones under Hann envelopes, which leave many bins
  just above the log(1e-5) clamp at the rounding noise of any fp32 FFT:
  there the plain fp32 run itself is up to 5.0e-3 off float64 (5,521 of
  11.3 M values beyond 2e-3; CPU), so no fp32 run agrees with it within the
  JAX package's 2e-3. The kernel computes in float64, so the card's log-mel
  is held against the float64 run, within the JAX package's bound (2e-3 +
  1e-4 |ref|) at every value and MAE < 1e-3, and against the plain run with
  MAE < 1e-3;
- energy and kurtosis in their raw units (standardised values times the
  tree's std plus its mean, from `stats.json`): char energy 1e-5 relative,
  kurtosis 1e-4 + 1e-4 |ref|, the bounds of the kernel against its plain
  version. The kurtosis std is 0.5% of its mean here (0.654 of 129.06), so
  standardising would magnify a raw difference of 1e-3 to 1.5e-3; in
  `stats.json` the raw min, max and mean take the same bounds and the std
  the bound at the largest |value|.

Imports no JAX (the reused reference modules are host-only). Needs an
NVIDIA GPU; on the card:

    python -m pytest tests/test_torch_preprocess_cuda.py -q
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

CLIPS, LABELS, BATCH = 256, 2, 64
MEL_ATOL, MEL_RTOL, MEL_MAE = 2e-3, 1e-4, 1e-3
RAW_BOUNDS = {"energy": (0.0, 1e-5), "kurtosis": (1e-4, 1e-4)}   # (atol, rtol)
METADATA = ("train.txt", "val.txt", "test.txt", "audiotype.json", "label_width.json",
            "visual_text.json", "symbols.json")


def _files(tree: pathlib.Path) -> set[str]:
    return {str(p.relative_to(tree)) for p in tree.rglob("*") if p.is_file()}


def _float64_preprocessor():
    from visual_onoma_to_wave_tpu.data.preprocess import MAX_CHARS
    from visual_onoma_to_wave_tpu_torch.data.features import pad_batch
    from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor
    from visual_onoma_to_wave_tpu_torch.ops import stft

    class Float64Preprocessor(Preprocessor):
        """Pass 1 in float64 on the CPU, rounded to float32 at the end."""

        def _features_dispatch(self, audios, durations):
            batch, dur = pad_batch(audios, durations, n_fft=self.n_fft, hop_length=self.hop,
                                   max_chars=MAX_CHARS)
            window = torch.from_numpy(stft.hann_window(self.win)).double()
            fb = torch.from_numpy(stft.melscale_fbanks(self.n_fft // 2 + 1, self.fmin, self.fmax,
                                                       self.n_mels, self.sr)).double()
            out = stft.clip_features(torch.from_numpy(batch).double(), torch.from_numpy(dur),
                                     window, fb, MAX_CHARS, self.n_fft, self.hop, self.win)
            return tuple(o.float() for o in out)

    return Float64Preprocessor


def _raw(tree: pathlib.Path, stats: dict, name: str, f: str) -> np.ndarray:
    _, _, mean, std = stats[name]
    return np.load(tree / f).astype(np.float64) * std + mean


@pytest.mark.gpu
def test_preprocessor_build_on_the_card_matches_the_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: pass 1 runs the CUDA mel kernel here")
    from benchmarks.bench_preprocess import build_corpus
    from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor
    from visual_onoma_to_wave_tpu_torch.ops.mel import mel_frontend

    cfg = build_corpus(tmp_path, CLIPS, n_labels=LABELS)
    trees = {}
    for run, cls, device in (("cuda", Preprocessor, "cuda"), ("cpu", Preprocessor, "cpu"),
                             ("float64", _float64_preprocessor(), "cpu")):
        out = tmp_path / f"preprocessed_{run}"
        pre = cls(cfg.replace(path=cfg.path.__class__(
            corpus=cfg.path.corpus, formatted=cfg.path.formatted, preprocessed=str(out),
            font="")), device=device)
        dispatch, batches = pre._features_dispatch, []

        def counted(audios, durations, dispatch=dispatch, batches=batches):
            batches.append(len(audios))
            return dispatch(audios, durations)

        pre._features_dispatch = counted
        launches = mel_frontend.launches
        pre.build(verbose=False)
        trees[run] = out
        if run == "cuda":
            torch.cuda.synchronize()
            assert batches == [BATCH] * (CLIPS // BATCH), batches
            assert mel_frontend.launches - launches == len(batches)
        else:
            assert mel_frontend.launches == launches
    hold(trees["cuda"], trees["cpu"], trees["float64"])


def hold(gpu: pathlib.Path, cpu: pathlib.Path, exact: pathlib.Path) -> None:
    """Hold the card's artifact tree against the plain and float64 trees."""
    files = _files(cpu)
    assert files == _files(gpu) == _files(exact) and any(f.startswith("mel/") for f in files)
    for f in sorted(files):
        if f.split("/")[0] in ("duration", "image") or f in METADATA:
            assert (gpu / f).read_bytes() == (cpu / f).read_bytes(), f

    for f in sorted(f for f in files if f.startswith("mel/")):
        g, c, e = (np.load(t / f) for t in (gpu, cpu, exact))
        assert g.shape == c.shape == e.shape and np.isfinite(g).all(), f
        err = np.abs(g - e)
        assert (err <= MEL_ATOL + MEL_RTOL * np.abs(e)).all(), (f, err.max(), np.abs(c - e).max())
        assert err.mean() < MEL_MAE and np.abs(g - c).mean() < MEL_MAE, f

    got, want = (json.loads((t / "stats.json").read_text()) for t in (gpu, cpu))
    for name, (atol, rtol) in RAW_BOUNDS.items():
        for f in sorted(f for f in files if f.startswith(f"{name}/")):
            np.testing.assert_allclose(_raw(gpu, got, name, f), _raw(cpu, want, name, f),
                                       atol=atol, rtol=rtol, err_msg=f)
        (g_min, g_max, g_mean, g_std), (c_min, c_max, c_mean, c_std) = got[name], want[name]
        g_range = np.array([g_min, g_max]) * g_std + g_mean
        c_range = np.array([c_min, c_max]) * c_std + c_mean
        np.testing.assert_allclose([*g_range, g_mean], [*c_range, c_mean], atol=atol, rtol=rtol,
                                   err_msg=name)
        assert abs(g_std - c_std) <= atol + rtol * np.abs(c_range).max(), (name, g_std, c_std)
