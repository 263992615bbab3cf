"""The port's demo quality gate (`tools/eval_quality_demo_torch.py`) against
the reference's (`benchmarks/eval_quality_demo.py`, whose scoring is
`benchmarks/bench_vocoder_quality.py::make_scorer` and `jit_logmel`).

In Tier-1: on the val clips of a small synthetic corpus that the port
preprocesses with --save-audio, the port's mel matches `jit_logmel`'s
bin for bin within 5e-7 of the bin plus 1e-7 of the clip's largest mel
value (compared before the log; float32 on both sides: the loud bins
differ by ~2e-7 of themselves, the quiet ones by a roundoff of the clip's
scale, ~2e-8 of its max, which the log near its ln(1e-5) floor turns into
up to 2.4e-3 nats; the bound holds a bin at the floor to ~0.03 nats),
and the port's
copy-synthesis scores through the committed demo HiFi-GAN match
`make_scorer`'s within 1e-3 relative (the reference rounds its scores to 4
decimals, MCD to 2). Marked slow: the whole gate (n_per_class 60, the
acoustic model and all three vocoders) against the reference tool's output,
1e-3 relative on every number.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "benchmarks"))
sys.path.insert(0, str(ROOT / "examples"))

import eval_quality_demo_torch as gate  # noqa: E402

REL = 1e-3
SCORES = ("mel_l1", "mcd_db", "mrstft_sc", "mrstft_mag", "mrstft")


@pytest.fixture(scope="module")
def small_corpus(tmp_path_factory):
    """(config, preprocessed dir) of the synthetic corpus at 2 x 4 clips,
    preprocessed with --save-audio by the port on the CPU."""
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.data.formatting import format_dataset
    from visual_onoma_to_wave_tpu_torch.data.labels import prepare_textgrids
    from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor
    from visual_onoma_to_wave_tpu_torch.data.synthetic_corpus import build_corpus, work_config

    root = tmp_path_factory.mktemp("gate")
    raw_root, ono_root = build_corpus(root, 4)
    cfg = work_config(root, ono_root, 1)
    cfg["dataset"]["valtest_id"] = [1, 2]
    (root / "cfg.json").write_text(json.dumps(cfg))
    config = load_config(root / "cfg.json")
    format_dataset(config, raw_root)
    prepare_textgrids(config.path.formatted, list(config.dataset.extract_labels))
    Preprocessor(config, num_workers=1, save_audio=True, device="cpu").build(verbose=False)
    return config, pathlib.Path(config.path.preprocessed)


def _jax_logmel(audio_cfg):
    from bench_vocoder_quality import jit_logmel

    st, mel = audio_cfg.stft, audio_cfg.mel
    return jit_logmel(st.filter_length, st.hop_length, st.win_length, mel.n_mel_channels,
                      mel.mel_fmin, mel.mel_fmax, audio_cfg.sampling_rate)


def test_ground_truth_and_logmel_match_jit_logmel(small_corpus):
    import jax.numpy as jnp

    config, pre = small_corpus
    hop = config.audio.stft.hop_length
    gt = gate.ground_truth(pre, hop, gate.make_logmel(config.audio, "cpu"))
    assert 2 <= len(gt) <= 4
    jlogmel = _jax_logmel(config.audio)
    for wav, mel in gt:
        assert len(wav) % hop == 0
        want = np.asarray(jlogmel(jnp.asarray(wav)[None]))[0]
        assert mel.shape == want.shape == (config.audio.mel.n_mel_channels, len(wav) // hop + 1)
        np.testing.assert_allclose(np.exp(mel), np.exp(want), rtol=5e-7,
                                   atol=1e-7 * np.exp(want).max())


def test_demo_hifigan_scores_match_make_scorer(small_corpus):
    import jax.numpy as jnp
    from bench_vocoder_quality import make_scorer

    from visual_onoma_to_wave_tpu.models.vocoder import get_vocoder as jax_get_vocoder
    from visual_onoma_to_wave_tpu.utils.checkpoint import load_params
    from visual_onoma_to_wave_tpu_torch.bridge import load_npz, vocoder_state_dict
    from visual_onoma_to_wave_tpu_torch.models.vocoder import get_vocoder

    config, pre = small_corpus
    hop = config.audio.stft.hop_length
    logmel = gate.make_logmel(config.audio, "cpu")
    gt = gate.ground_truth(pre, hop, logmel)[:3]
    kwargs = json.loads((gate.DEMO / "config.json").read_text())["model"]["vocoder_kwargs"]
    gen = get_vocoder("HiFi-GAN", **kwargs)
    gen.load_state_dict(vocoder_state_dict("HiFi-GAN",
                                           load_npz(gate.DEMO / "torch" / "vocoder.npz")))
    got = gate.make_scorer(gen, gt, logmel, "cpu")()

    jlogmel = _jax_logmel(config.audio)
    jgt = [(wav, np.asarray(jlogmel(jnp.asarray(wav)[None]))[0]) for wav, _ in gt]
    want = make_scorer(jax_get_vocoder("HiFi-GAN", **kwargs), jgt, jlogmel)(
        load_params(gate.DEMO / "vocoder"))
    print("port:", got, "reference:", want)
    for k in SCORES:
        assert got[k] == pytest.approx(want[k], rel=REL), k


def test_demo_model_and_stats_check():
    from train_demo_artifacts import DEMO_MODEL as reference

    from visual_onoma_to_wave_tpu_torch.data.synthetic_corpus import DEMO_MODEL

    assert DEMO_MODEL == reference
    committed = gate.DEMO / "preprocessed" / "stats.json"
    gate.check_stats(committed, committed)


def test_stats_check_refuses_a_diverging_corpus(tmp_path):
    stats = json.loads((gate.DEMO / "preprocessed" / "stats.json").read_text())
    k = next(iter(stats))
    stats[k] = [stats[k][0] + 2 * gate.STATS_TOL] + list(stats[k][1:])
    (tmp_path / "stats.json").write_text(json.dumps(stats))
    with pytest.raises(RuntimeError, match="diverge"):
        gate.check_stats(gate.DEMO / "preprocessed" / "stats.json", tmp_path / "stats.json")


@pytest.mark.slow  # ~1.5 min: both tools build and preprocess the 120-clip corpus
def test_full_gate_matches_the_reference_tool(tmp_path):
    """Every number of the port's gate within 1e-3 relative of the
    reference tool's, run on the CPU in a subprocess."""
    ref = subprocess.run(
        [sys.executable, str(ROOT / "benchmarks" / "eval_quality_demo.py"), "--cpu",
         "--work", str(tmp_path / "ref")], check=True, capture_output=True, text=True,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"}, cwd=ROOT)
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    got = gate.run_gate(tmp_path / "port", "cpu")
    print("port:", json.dumps(got), "reference:", json.dumps(want))
    for k, v in want.items():
        if k == "vocoders":
            for tag, scores in v.items():
                assert got[k][tag]["family"] == scores["family"]
                assert got[k][tag]["clips"] == scores["clips"]
                for s in SCORES:
                    assert got[k][tag][s] == pytest.approx(scores[s], rel=REL), (tag, s)
        elif isinstance(v, float) and v != 0.0:
            assert got[k] == pytest.approx(v, rel=REL), k
        else:
            assert got[k] == v, k
