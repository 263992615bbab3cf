"""The port's host C kernels (`data/native.py`, `csrc/datakernels.c`) on the CPU.

Each function against its numpy twin and against the JAX package's native
library, bit for bit: `dtw_path_f64` on random cost matrices (square, long,
wide, one row, and integer costs full of ties), `pad_cells_u8` on random
glyph strips (glyphs narrower and wider than the cell). `metrics.mcd_dtw` gives the same value through the C kernel and
through the numpy DP.
"""
from __future__ import annotations

import numpy as np
import pytest

from visual_onoma_to_wave_tpu import native as jnative
from visual_onoma_to_wave_tpu_torch import metrics
from visual_onoma_to_wave_tpu_torch.data import native
from visual_onoma_to_wave_tpu_torch.data.dataset import pad_character_cells

pytestmark = pytest.mark.skipif(not native.available(), reason="no C compiler on this host")


@pytest.mark.parametrize("shape,ties", [((40, 40), False), ((120, 31), False),
                                        ((7, 129), False), ((1, 9), False), ((25, 30), True)],
                         ids=["square", "long", "wide", "one-row", "ties"])
def test_dtw_path_equals_numpy_and_jax(shape, ties):
    rng = np.random.default_rng(sum(shape))
    cost = (rng.integers(0, 3, shape).astype(np.float64) if ties
            else rng.uniform(0, 5, shape))
    got = native.dtw_path_f64(cost)
    for want in (metrics.dtw_path(cost), jnative.dtw_path_f64(cost)):
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_cells_equal_numpy_and_jax():
    rng = np.random.default_rng(0)
    for n, cell in ((4, 30), (7, 24), (3, 10)):
        widths = rng.integers(5, 36, n).astype(np.int64)
        img = rng.integers(0, 256, (24, int(widths.sum()))).astype(np.uint8)
        got = native.pad_cells_u8(img, widths, cell)
        assert np.array_equal(got, pad_character_cells(img, widths, cell))
        assert np.array_equal(got, jnative.pad_cells_u8(img, widths, cell))


def test_mcd_dtw_same_through_c_and_numpy(monkeypatch):
    rng = np.random.default_rng(3)
    pred, gt = rng.normal(-5, 2, (57, 80)), rng.normal(-5, 2, (64, 80))
    through_c = metrics.mcd_dtw(pred, gt)
    monkeypatch.setattr(metrics, "_dtw", metrics.dtw_path)
    assert metrics.mcd_dtw(pred, gt) == through_c
