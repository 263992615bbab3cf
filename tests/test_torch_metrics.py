"""The port's quality metrics (`visual_onoma_to_wave_tpu_torch/metrics.py`)
against the JAX package's `metrics.py`, on the same numpy inputs.

The port fills the DTW table by anti-diagonals; the JAX package fills it
row by row in numpy or in its native C kernel. The paths must be the same
index for index, ties included (constant and integer-valued costs force
them), and every metric the same within 1e-12.
"""
from __future__ import annotations

import numpy as np
import pytest

import visual_onoma_to_wave_tpu.metrics as jm
from visual_onoma_to_wave_tpu import native
from visual_onoma_to_wave_tpu_torch import metrics as tm

N_MELS = 80
FLOOR = float(np.log(1e-5))


def cost_matrix(kind: str, shape: tuple[int, int]) -> np.ndarray:
    rng = np.random.default_rng(sum(shape))
    if kind == "random":
        return rng.uniform(0.0, 5.0, shape)
    if kind == "integer":        # few distinct values: many equal sums
        return rng.integers(0, 3, shape).astype(np.float64)
    return np.ones(shape)        # constant: every move ties


SHAPES = [(1, 1), (1, 9), (9, 1), (17, 23), (23, 17), (30, 30)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["random", "integer", "constant"])
def test_dtw_path_matches_jax(kind, shape):
    cost = cost_matrix(kind, shape)
    pi, pj = tm.dtw_path(cost)
    for ref in (jm.dtw_path, native.dtw_path_f64 if native.available() else None):
        if ref is None:
            continue
        ri, rj = ref(cost)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pj, rj)


def logmel_pair(kind: str, t_pred: int, t_gt: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    if kind == "constant":       # every frame alike: the DTW ties throughout
        return np.full((t_pred, N_MELS), -3.0), np.full((t_gt, N_MELS), -2.0)
    return (rng.normal(-4.0, 2.0, (t_pred, N_MELS)),
            rng.normal(-4.0, 2.0, (t_gt, N_MELS)))


@pytest.mark.parametrize("lengths", [(40, 40), (31, 47), (47, 31), (1, 12)],
                         ids=lambda s: f"{s[0]}-{s[1]}")
@pytest.mark.parametrize("kind", ["random", "constant"])
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_mcd_dtw_matches_jax(kind, lengths, use_native, monkeypatch):
    if use_native and not native.available():
        pytest.skip("the JAX package's native DTW kernel did not build")
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    pred, gt = logmel_pair(kind, *lengths)
    got, want = tm.mcd_dtw(pred, gt), jm.mcd_dtw(pred, gt)
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), (got, want)


def test_frame_metrics_match_jax():
    pred, gt = logmel_pair("random", 37, 37, seed=3)
    for name in ("mcd_frames", "mel_l1"):
        got, want = getattr(tm, name)(pred, gt), getattr(jm, name)(pred, gt)
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), (name, got, want)
    np.testing.assert_array_equal(tm.voiced_mask(gt), jm.voiced_mask(gt))
    np.testing.assert_array_equal(tm.mel_cepstra(pred), jm.mel_cepstra(pred))


@pytest.mark.parametrize("call", [
    lambda m: m.mcd_dtw(np.zeros((0, N_MELS)), np.zeros((4, N_MELS))),
    lambda m: m.mcd_frames(np.zeros((3, N_MELS)), np.zeros((4, N_MELS))),
    lambda m: m.mel_l1(np.zeros((3, N_MELS)), np.zeros((4, N_MELS))),
    lambda m: m.mrstft_distance(np.zeros(1000), np.zeros(2000)),
    lambda m: m.mrstft_distance(np.zeros(0), np.zeros(0)),
], ids=["dtw-empty", "frames-shape", "l1-shape", "mrstft-length", "mrstft-empty"])
def test_errors_match_jax(call):
    for m in (tm, jm):
        with pytest.raises(ValueError):
            call(m)


def quality_batch(seed: int = 0) -> dict:
    """Padded teacher-forced, free-running and ground-truth mels of 4 items:
    one all-silent (no voiced frame: mcd_voiced falls back to all frames),
    one whose free-running length is 0 (scored as 1 frame), one whose
    teacher-forced mel equals the target."""
    rng = np.random.default_rng(seed)
    B, T = 4, 48
    gt_lens = np.array([48, 30, 21, 9], np.int32)
    fr_lens = np.array([44, 0, 25, 9], np.int32)
    gt = rng.normal(-4.0, 2.0, (B, T, N_MELS))
    gt[2] = FLOOR
    tf = gt + rng.normal(0.0, 0.5, gt.shape)
    tf[3] = gt[3]
    fr = rng.normal(-4.0, 2.0, (B, T, N_MELS))
    return dict(tf_mels=tf.astype(np.float32), fr_mels=fr.astype(np.float32), fr_lens=fr_lens,
                gt_mels=gt.astype(np.float32), gt_lens=gt_lens)


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_quality_metrics_match_jax(seed):
    b = quality_batch(seed)
    assert not jm.voiced_mask(b["gt_mels"][2, :b["gt_lens"][2]]).any()
    got, want = tm.batch_quality_metrics(**b), jm.batch_quality_metrics(**b)
    assert got.keys() == want.keys()
    for k in want:
        assert np.isfinite(got[k])
        assert abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k])), (k, got[k], want[k])


@pytest.mark.parametrize("lengths", [(16000, 16000), (16000, 16007), (5000, 4990)],
                         ids=lambda s: f"{s[0]}-{s[1]}")
def test_mrstft_distance_matches_jax(lengths):
    rng = np.random.default_rng(lengths[1])
    gt = rng.normal(0.0, 0.3, lengths[1]).astype(np.float32)
    pred = np.resize(gt, lengths[0]) + rng.normal(0.0, 0.05, lengths[0]).astype(np.float32)
    got, want = tm.mrstft_distance(pred, gt), jm.mrstft_distance(pred, gt)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12 * max(1.0, abs(want[k])), (k, got[k], want[k])
