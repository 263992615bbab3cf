"""Whole models of the PyTorch port against the JAX package, at tiny sizes.

* `VTTS`: the deterministic forward with predicted durations, image path
  and token path, scalar and per-item controls. duration_rounded and
  mel_lens must be exactly equal; the mels agree to 1e-4 absolute (float32
  on both sides, about twenty layers deep, values of O(1-10)).
* `HiFiGANGenerator`: V1 (and V3's ResBlock2) at upsample_initial_channel
  32 on a short mel, at tests/test_hifigan.py's tolerance (2e-5).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu.models.hifigan import HIFIGAN_PRESETS
from visual_onoma_to_wave_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from visual_onoma_to_wave_tpu.models.vtts import VTTS as JVTTS
from visual_onoma_to_wave_tpu_torch.bridge import hifigan_state_dict, vtts_state_dict
from visual_onoma_to_wave_tpu_torch.models import VTTS, HiFiGANGenerator

from test_torch_layers import init_random

TINY = dict(n_vocab=20, n_audiotype=3, hidden=128, encoder_layers=2, decoder_layers=2,
            n_head=2, d_inner=64, max_seq_len=32, max_mel_len=80, vp_filter=32,
            n_bins=16, postnet_dim=32, vfe_layers=2,
            energy_stats=(-1.0, 2.0, 0.2, 1.3), kurtosis_stats=(-2.0, 1.0, 0.1, 0.9))


def _inputs(rng, B=3, C=6):
    return dict(audiotypes=np.array([0, 2, 1], np.int32)[:B],
                texts=rng.integers(1, 21, (B, C)).astype(np.int32),
                src_lens=np.array([6, 4, 2], np.int32)[:B],
                image_cells=rng.uniform(0, 1, (B, C, 8, 12)).astype(np.float32))


@pytest.mark.parametrize("use_image,controls", [
    (True, (1.0, 1.0)),
    (True, ([1.2, 0.8, 1.0], [1.0, 1.6, 0.5])),
    (False, (1.0, 1.0)),
], ids=["image", "image-per-item-controls", "tokens"])
def test_vtts_forward_matches_jax(use_image, controls):
    rng = np.random.default_rng(0)
    inp = _inputs(rng)
    jm = JVTTS(**TINY, is_kurtosis=True)
    v = init_random(jm, rng, **inp, use_image=use_image, scale=0.1)
    # ~5 frames per character, so mel lengths differ per item; the decoder
    # runs at max_mel_len > max_seq_len, past the stored position table
    dur = v["params"]["variance_adaptor"]["duration_predictor"]["linear_layer"]
    dur["kernel"] = dur["kernel"] * 0.1
    dur["bias"] = jnp.full_like(dur["bias"], np.log(6.0))
    e, d = (c if np.isscalar(c) else np.asarray(c, np.float32) for c in controls)
    ref = jm.apply(v, **inp, use_image=use_image, e_control=e, d_control=d)

    tm = VTTS(**TINY, is_kurtosis=True, use_image=use_image, cell_hw=(8, 12))
    tm.load_state_dict(vtts_state_dict(jax.tree.map(np.asarray, v)))
    ctl = {k: (c if np.isscalar(c) else torch.from_numpy(c))
           for k, c in (("e_control", e), ("d_control", d))}
    with torch.inference_mode():
        out = tm.eval()(**{k: torch.from_numpy(a) for k, a in inp.items()}, **ctl)

    np.testing.assert_array_equal(out["duration_rounded"].numpy(),
                                  np.asarray(ref["duration_rounded"]))
    np.testing.assert_array_equal(out["mel_lens"].numpy(), np.asarray(ref["mel_lens"]))
    for k in ("mel", "postnet_mel", "energy_pred", "kurtosis_pred", "log_duration_pred"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("preset", ["v1", "v3"])
def test_hifigan_matches_jax(preset):
    rng = np.random.default_rng(1)
    kw = dict(HIFIGAN_PRESETS[preset], upsample_initial_channel=32)
    mel = rng.normal(size=(2, 17, 80)).astype(np.float32)
    jm = JHiFiGAN(**kw)
    v = init_random(jm, rng, mel, scale=0.1)
    ref = np.asarray(jm.apply(v, mel))
    tm = HiFiGANGenerator(**kw)
    tm.load_state_dict(hifigan_state_dict(jax.tree.map(np.asarray, v)))
    with torch.inference_mode():
        out = tm.eval()(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, 17 * 256)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
