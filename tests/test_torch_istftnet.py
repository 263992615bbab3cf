"""The iSTFTNet generators of the PyTorch port against the JAX package, on the CPU.

Weights are made with numpy from a seed (`init_random`), given to the JAX
generator as they are and to the port's through the weight bridge. On the
CPU the port runs each MRF stage through its `ResBlock1` modules (on the
card through the fused MRF kernel, chip_smoke phases 9-10). Tolerances,
float32 on both sides:

* the generators at tiny widths, the same math in another summation order:
  with weights of scale 0.1 the waveforms reach O(30) (magnitudes up to the
  head's cap of 100), held within 1e-5 x max |JAX|; with weights of scale
  0.05 they stay O(0.1), held within 1e-5 absolute;
* the demo iSTFTNet-mel golden: durations and mel lengths exact, mel 1e-4
  and waveform 1e-5 absolute, as the HiFi-GAN and Vocos goldens.
"""
from __future__ import annotations

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu.models import istftnet as jistftnet
from visual_onoma_to_wave_tpu.models.hifigan import convert_torch_state_dict
from visual_onoma_to_wave_tpu_torch.bridge import (
    flatten_tree,
    hifigan_state_dict,
    load_npz,
    vocoder_state_dict,
)
from visual_onoma_to_wave_tpu_torch.models import ISTFTNetGenerator, build_istftnet, get_vocoder
from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer, make_fused_infer

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples"))
import export_demo_for_torch as export  # noqa: E402
from test_torch_layers import init_random  # noqa: E402

TINY = {"c8c8i": 64, "melrate": 32}


def _of_scale(out, ref) -> float:
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-3))


@pytest.mark.parametrize("scale", [0.1, 0.05], ids=["loud", "quiet"])
@pytest.mark.parametrize("T", [12, 7], ids=["T12", "T7"])
@pytest.mark.parametrize("preset", ["c8c8i", "melrate"])
def test_generator_matches_jax(preset, T, scale):
    rng = np.random.default_rng(T)
    mel = rng.normal(-1, 1, (2, T, 80)).astype(np.float32)
    jg = jistftnet.build_istftnet(preset, upsample_initial_channel=TINY[preset])
    variables = init_random(jg, rng, jnp.asarray(mel), scale=scale)
    ref = np.asarray(jg.apply(variables, jnp.asarray(mel)))
    tg = build_istftnet(preset, upsample_initial_channel=TINY[preset]).eval()
    tg.load_state_dict(hifigan_state_dict(jax.tree.map(np.asarray, variables)))   # strict
    with torch.no_grad():
        out = tg(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, T * 256) and tg.total_upsample == jg.total_upsample
    if scale == 0.1:
        assert _of_scale(out, ref) < 1e-5
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("preset", ["c8c8i", "melrate"])
def test_receptive_halo_frames_equal_jax(preset):
    for kw in ({}, {"post_kernel_size": 5}, {"resblock_dilations": ((1, 2, 4),) * 3}):
        assert build_istftnet(preset, **kw).receptive_halo_frames() == \
            jistftnet.build_istftnet(preset, **kw).receptive_halo_frames()


def test_c8c8i_bridge_round_trip():
    """convert_torch_state_dict (the JAX package's HiFi-GAN reader) inverts
    the bridge on a C8C8I tree: same names as HiFi-GAN, two upsamplings."""
    jg = jistftnet.build_istftnet("c8c8i", upsample_initial_channel=32)
    tree = init_random(jg, np.random.default_rng(1), jnp.zeros((1, 4, 80)))
    sd = {k: v.numpy() for k, v in hifigan_state_dict(tree).items()}
    back = convert_torch_state_dict(sd, upsample_rates=(8, 8))
    want = flatten_tree(tree["params"])
    got = flatten_tree(jax.tree.map(np.asarray, back))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_packing_follows_weight_changes():
    """The packed stage is made once and again only after a weight changes."""
    g = build_istftnet("melrate", upsample_initial_channel=32)
    stage = g._stage_blocks(0)
    first = g._mrf.packed(0, stage, torch.float32)
    assert g._mrf.packed(0, stage, torch.float32) is first
    g.load_state_dict({k: v + 1.0 for k, v in g.state_dict().items()})
    again = g._mrf.packed(0, stage, torch.float32)
    assert again is not first
    assert torch.equal(again[1], first[1] + 1.0)


def test_get_vocoder_builds_both_presets_from_the_demo_config():
    m = export.port_demo_config("config_istftnet.json").model
    gen = get_vocoder(m.vocoder_model, **dict(m.vocoder_kwargs))
    assert isinstance(gen, ISTFTNetGenerator) and gen.upsample_rates == ()
    assert gen.istft_n_fft == 1024 and len(gen.resblocks) == 3 and gen.total_upsample == 256
    c8 = get_vocoder("iSTFTNet")
    assert c8.upsample_rates == (8, 8) and c8.istft_n_fft == 16
    assert [b.convs1[0].in_channels for b in c8.resblocks] == [256] * 3 + [128] * 3
    tree = load_npz(export.OUT / "vocoder_istftnet_mel.npz")
    gen.load_state_dict(vocoder_state_dict(m.vocoder_model, tree))       # strict


def test_committed_istftnet_npz_equals_export():
    got = flatten_tree(load_npz(export.OUT / "vocoder_istftnet_mel.npz"))
    want = flatten_tree(export.weight_trees(("vocoder_istftnet_mel",))["vocoder_istftnet_mel"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def golden_istftnet():
    return dict(np.load(export.OUT / "golden_istftnet.npz"))


@pytest.fixture(scope="module")
def synth_istftnet():
    return Synthesizer.from_checkpoint(export.port_demo_config("config_istftnet.json"),
                                       str(export.OUT / "acoustic.npz"),
                                       str(export.OUT / "vocoder_istftnet_mel.npz"), device="cpu")


def test_synthesizer_reproduces_istftnet_golden(synth_istftnet, golden_istftnet):
    synth, g = synth_istftnet, golden_istftnet
    seen = {}
    run = synth._run

    def spy(batch, e_ctl, d_ctl):
        seen.update(batch, e_control=e_ctl, d_control=d_ctl)
        out = run(batch, e_ctl, d_ctl)
        seen.update(out)
        return out

    synth._run = spy
    texts, types, rates, e, d = zip(*export.GOLDEN_REQUESTS)
    try:
        results = synth.synthesize_batch(list(texts), list(types), width_rates=list(rates),
                                         e_control=list(e), d_control=list(d))
    finally:
        del synth._run
    for k in export.GOLDEN_INPUTS + ("duration_rounded", "mel_lens"):
        np.testing.assert_array_equal(seen[k], g[k], err_msg=k)
    for k, tol in (("postnet_mel", 1e-4), ("wav", 1e-5)):
        np.testing.assert_allclose(seen[k], g[k], rtol=0, atol=tol, err_msg=k)
    for i, r in enumerate(results):
        assert r.wav.shape == (g["mel_lens"][i] * 256,) and np.isfinite(r.wav).all()


def test_fused_infer_on_istftnet_golden_inputs(synth_istftnet, golden_istftnet):
    g = golden_istftnet
    out = make_fused_infer(synth_istftnet.model, synth_istftnet.vocoder)(
        {k: torch.from_numpy(g[k]) for k in ("audiotypes", "texts", "src_lens", "image_cells")},
        e_control=torch.from_numpy(g["e_control"]), d_control=torch.from_numpy(g["d_control"]))
    np.testing.assert_array_equal(out["mel_lens"].numpy(), g["mel_lens"])
    np.testing.assert_allclose(out["wav"].numpy(), g["wav"], rtol=0, atol=1e-5)


def test_istftnet_golden_still_matches_the_jax_package(golden_istftnet):
    """golden_istftnet.npz is what the JAX package serves now (XLA CPU,
    float32; 1e-5 / 1e-6 absolute for a different CPU's vector code)."""
    now = export.golden("config_istftnet.json", "vocoder_istftnet_mel")
    assert sorted(now) == sorted(golden_istftnet)
    for k in golden_istftnet:
        if golden_istftnet[k].dtype.kind == "f" and k not in export.GOLDEN_INPUTS:
            tol = 1e-5 if k == "postnet_mel" else 1e-6
            np.testing.assert_allclose(now[k], golden_istftnet[k], rtol=0, atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(now[k], golden_istftnet[k], err_msg=k)
