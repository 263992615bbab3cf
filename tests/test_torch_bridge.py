"""The weight bridge (`visual_onoma_to_wave_tpu_torch/bridge.py`) and the
committed demo weights for the PyTorch port.

The reference converters read the reference PyTorch layout into flax trees
(`convert_vtts_state_dict`, `convert_torch_state_dict`); the bridge writes
flax trees into that layout, so converting the bridge's output must give
back every leaf exactly. The port's modules load the bridge's state_dicts
strictly (no missing or unexpected key).
"""
from __future__ import annotations

import pathlib
import sys

import jax
import numpy as np
import pytest

from visual_onoma_to_wave_tpu.models.convert_acoustic import convert_vtts_state_dict
from visual_onoma_to_wave_tpu.models.hifigan import HIFIGAN_PRESETS
from visual_onoma_to_wave_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from visual_onoma_to_wave_tpu.models.hifigan import convert_torch_state_dict
from visual_onoma_to_wave_tpu.models.vtts import VTTS as JVTTS
from visual_onoma_to_wave_tpu_torch.bridge import (
    flatten_tree,
    hifigan_state_dict,
    load_npz,
    vtts_state_dict,
)
from visual_onoma_to_wave_tpu_torch.models import VTTS, HiFiGANGenerator, get_vocoder

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
sys.path.insert(0, str(EXAMPLES))
import export_demo_for_torch as export  # noqa: E402
from test_torch_layers import init_random  # noqa: E402


@pytest.fixture(scope="module")
def demo_trees():
    return export.weight_trees()


def _numpy(sd: dict) -> dict:
    return {k: v.numpy() for k, v in sd.items()}


def assert_same_tree(got, want) -> None:
    got, want = flatten_tree(jax.tree.map(np.asarray, got)), flatten_tree(want)
    assert all(v.dtype == np.float32 for v in got.values())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_demo_acoustic_round_trip_and_strict_load(demo_trees):
    tree = demo_trees["acoustic"]
    sd = vtts_state_dict(tree)
    back = convert_vtts_state_dict(_numpy(sd), encoder_layers=2, decoder_layers=2,
                                   vfe_layers=2)
    assert_same_tree(back, tree)
    cfg = export.demo_config()
    from visual_onoma_to_wave_tpu.config import DatasetMetadata
    meta = DatasetMetadata.load(cfg.path.preprocessed)
    model = VTTS.from_config(cfg, meta, n_vocab=12)
    model.load_state_dict(sd)          # strict: every parameter and buffer named


def test_demo_vocoder_round_trip_and_strict_load(demo_trees):
    tree = demo_trees["vocoder"]
    sd = hifigan_state_dict(tree)
    assert_same_tree({"params": convert_torch_state_dict(_numpy(sd))}, tree)
    get_vocoder("HiFi-GAN", upsample_initial_channel=128).load_state_dict(sd)


def test_rgb_vfe_tokens_and_kurtosis_round_trip():
    """The parts the demo tree lacks: a 3-channel VFE (bridge rows reordered
    NHWC -> NCHW), the token embedding, the kurtosis branch."""
    rng = np.random.default_rng(0)
    kw = dict(n_vocab=9, n_audiotype=2, hidden=16, encoder_layers=1, decoder_layers=1,
              d_inner=8, vp_filter=8, n_bins=8, postnet_dim=8, max_mel_len=16,
              vfe_layers=1, is_kurtosis=True)
    inp = dict(audiotypes=np.zeros(1, np.int32), texts=np.ones((1, 2), np.int32),
               src_lens=np.full(1, 2, np.int32),
               image_cells=rng.uniform(0, 1, (1, 2, 4, 5)).astype(np.float32))
    for use_image in (True, False):
        jm = JVTTS(**kw, vfe_channels=3)
        tree = init_random(jm, rng, **inp, use_image=use_image)
        sd = vtts_state_dict(tree)
        back = convert_vtts_state_dict(_numpy(sd), encoder_layers=1, decoder_layers=1,
                                       vfe_layers=1)
        assert_same_tree(back, tree)
        VTTS(**kw, vfe_channels=3, use_image=use_image, cell_hw=(4, 5)).load_state_dict(sd)


def test_hifigan_v3_round_trip():
    kw = dict(HIFIGAN_PRESETS["v3"], upsample_initial_channel=16)
    tree = init_random(JHiFiGAN(**kw), np.random.default_rng(1), np.zeros((1, 4, 80), np.float32))
    sd = hifigan_state_dict(tree)
    back = convert_torch_state_dict(
        _numpy(sd), upsample_rates=kw["upsample_rates"],
        resblock_kernel_sizes=kw["resblock_kernel_sizes"],
        resblock_dilations=kw["resblock_dilations"], resblock_type="2")
    assert_same_tree({"params": back}, tree)
    HiFiGANGenerator(**kw).load_state_dict(sd)


def test_unknown_leaves_raise():
    with pytest.raises(ValueError, match="unknown flax module"):
        vtts_state_dict({"params": {"odd": {"weight": np.zeros(1, np.float32)}}})
    tree = init_random(JHiFiGAN(upsample_initial_channel=8), np.random.default_rng(2),
                       np.zeros((1, 4, 80), np.float32))
    tree["params"]["stray"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        hifigan_state_dict(tree)


@pytest.mark.parametrize("name", ["acoustic", "vocoder"])
def test_committed_npz_equals_export(demo_trees, name):
    """examples/checkpoints/demo/torch/*.npz are what the export script
    writes from the orbax checkpoints now."""
    assert_same_tree(load_npz(export.OUT / f"{name}.npz"), demo_trees[name])
