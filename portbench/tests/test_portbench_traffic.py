"""The traffic generator: deterministic per seed, and the stated
distributions, with every seed sending the same set of sizes."""
from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import BENCH
from pbcore import traffic

CFG = json.loads((BENCH / "configs" / "icassp_hifigan_v1.json").read_text())
TYPES = CFG["metadata"]["audiotypes"]


def mix(name: str) -> dict:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def reqs(m: dict, seed: int, n: int, stream: int = 0) -> list[dict]:
    return traffic.make_requests(m, seed, n, stream, TYPES, 60, 22050, 256)


@pytest.mark.parametrize("name", ["batch64_full", "batch64_short"])
def test_same_seed_same_requests(name):
    m = mix(name)
    assert reqs(m, 2 ** 31 + 7, 64) == reqs(m, 2 ** 31 + 7, 64)
    assert reqs(m, 2 ** 31 + 7, 64) != reqs(m, 2 ** 31 + 8, 64)


@pytest.mark.parametrize("name", ["batch64_full", "batch64_short"])
def test_every_seed_the_same_sizes(name):
    m = mix(name)
    for key in (lambda r: len(r["text"]), lambda r: r["target_frames"]):
        sizes = [sorted(key(r) for r in reqs(m, s, 64)) for s in (1, 99, 2 ** 32 + 5)]
        assert sizes[0] == sizes[1] == sizes[2]


def test_batch64_full_distribution():
    m = mix("batch64_full")
    rs = reqs(m, 5, 64)
    frames = np.array([r["target_frames"] for r in rs])
    assert all(len(r["text"]) == 8 for r in rs)
    assert frames.min() >= 850 and frames.max() <= 1000
    # stratified uniform: one clip in each 1/64 of the range
    assert np.allclose(np.sort(frames), 850 + 150 * (np.arange(64) + 0.5) / 64)
    assert all(set(r["text"]) <= set(traffic.KATAKANA) for r in rs)
    assert all(0.5 <= w <= 2.0 for r in rs for w in r["width_rates"])
    # d_control scales 60 frames a character to the clip
    assert all(abs(r["d_control"] * 60 * 8 - r["target_frames"]) < 1e-3 for r in rs)


def test_batch64_short_distribution():
    m = mix("batch64_short")
    rs = reqs(m, 5, 700)
    chars = np.array([len(r["text"]) for r in rs])
    assert sorted(set(chars)) == list(range(2, 9))
    assert np.all(np.bincount(chars)[2:] == 100)
    secs = np.array([r["target_frames"] * 256 / 22050 for r in rs])
    assert secs.min() >= 0.3 and secs.max() <= 6.0
    # log-uniform: the log of the clip length is uniform over the range
    logs = np.sort(np.log(secs))
    expected = np.log(0.3) + (np.arange(700) + 0.5) / 700 * (np.log(6.0) - np.log(0.3))
    assert np.allclose(logs, expected)
    # every d_control is one the port's server would accept too
    from visual_onoma_to_wave_tpu_torch.serve import CONTROL_RANGE
    assert all(CONTROL_RANGE[0] <= r["d_control"] <= CONTROL_RANGE[1] for r in rs)
