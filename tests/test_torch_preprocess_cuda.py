"""The port's `Preprocessor.build` on the card.

A formatted corpus, the one of `benchmarks/bench_preprocess.py::build_corpus`
made with the port's host modules (256 clips over 2 labels: each label takes
two 64-clip batches, so the one-batch-in-flight pipeline runs), is
preprocessed three times: with
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

Imports nothing of JAX or of the JAX package. Needs an NVIDIA GPU; on the
card:

    python -m pytest tests/test_torch_preprocess_cuda.py -q
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

CLIPS, LABELS, BATCH = 256, 2, 64
SR, KATA = 22050, "パンドカタコツバチリン"
MEL_ATOL, MEL_RTOL, MEL_MAE = 2e-3, 1e-4, 1e-3
RAW_BOUNDS = {"energy": (0.0, 1e-5), "kurtosis": (1e-4, 1e-4)}   # (atol, rtol)
METADATA = ("train.txt", "val.txt", "test.txt", "audiotype.json", "label_width.json",
            "visual_text.json", "symbols.json")


def _files(tree: pathlib.Path) -> set[str]:
    return {str(p.relative_to(tree)) for p in tree.rglob("*") if p.is_file()}


def build_corpus(root: pathlib.Path, n_clips: int, n_labels: int, seed: int = 0):
    """benchmarks/bench_preprocess.py::build_corpus with the port's modules:
    tones under Hann envelopes, one per character, 0.1 s of silence around,
    their TextGrids and data.txt rows; returns the port's Config for it."""
    from visual_onoma_to_wave_tpu_torch.config import Config
    from visual_onoma_to_wave_tpu_torch.data.audio_io import write_wav
    from visual_onoma_to_wave_tpu_torch.data.labels import Interval, write_textgrid

    rng = np.random.default_rng(seed)
    formatted = root / "formatted"
    labels = [f"label{i}" for i in range(n_labels)]
    per = (n_clips + n_labels - 1) // n_labels
    for li, label in enumerate(labels):
        for d in ("audio", "TextGrid", "text"):
            (formatted / d / label).mkdir(parents=True)
        rows = []
        for c in range(per):
            n_chars = int(rng.integers(2, 7))
            text = "".join(rng.choice(list(KATA), n_chars))
            sec_per_char = float(rng.uniform(0.12, 0.3))
            lead = tail = 0.1
            total = lead + n_chars * sec_per_char + tail
            t = np.arange(int(total * SR)) / SR
            wav = np.zeros_like(t, dtype=np.float32)
            intervals = [Interval(0.0, lead, "")]
            cur = lead
            for i in range(n_chars):
                f = 200.0 * (1.15 ** (li * 3 + i))
                seg = (t >= cur) & (t < cur + sec_per_char)
                env = np.hanning(int(seg.sum())).astype(np.float32)
                wav[seg] = (0.5 * np.sin(2 * np.pi * f * t[seg])).astype(np.float32) * env
                intervals.append(Interval(cur, cur + sec_per_char, text[i]))
                cur += sec_per_char
            intervals.append(Interval(cur, total, ""))
            clip = f"c1_{label}_{c:03d}_0980"
            write_wav(formatted / "audio" / label / f"{clip}.wav", wav, SR)
            write_textgrid(intervals, formatted / "TextGrid" / label / f"{clip}_w1.TextGrid")
            rows.append(f"{clip}_w1|{clip}|{text}|{label}|5.0|4.0")
        (formatted / "text" / label / "data.txt").write_text("\n".join(rows) + "\n")
    cfg = Config()
    return cfg.replace(
        path=cfg.path.__class__(corpus=str(root / "raw"), formatted=str(formatted),
                                preprocessed=str(root / "preprocessed"), font=""),
        dataset=cfg.dataset.__class__(extract_labels=tuple(labels), valtest_id=(13,),
                                      confidence_score_border=3.0,
                                      acceptance_score_border=2.5))


def _float64_preprocessor():
    from visual_onoma_to_wave_tpu_torch.data.features import pad_batch
    from visual_onoma_to_wave_tpu_torch.data.preprocess import MAX_CHARS, Preprocessor
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
    from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor
    from visual_onoma_to_wave_tpu_torch.ops.mel import mel_frontend

    cfg = build_corpus(tmp_path, CLIPS, LABELS)
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
