"""The MelGAN generator of the PyTorch port against the JAX package, on the CPU.

Weights are made with numpy from a seed (`init_random`), given to the JAX
generator as they are and to the port's through `bridge.melgan_state_dict`.
Tolerances, float32 on both sides: the tiny generator (ngf 8) within 1e-5
absolute (waveforms in [-1, 1] after tanh); the bridge round trip exact; the
fused step with a MelGAN vocoder (which feeds it mel / ln 10) within 1e-5 of
the JAX package's `make_fused_infer(..., is_melgan=True)` on the demo
acoustic model and the golden requests' inputs.
"""
from __future__ import annotations

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu import synthesis as jsynthesis
from visual_onoma_to_wave_tpu.models import melgan as jmelgan
from visual_onoma_to_wave_tpu_torch.bridge import (
    flatten_tree,
    load_npz,
    melgan_state_dict,
    vocoder_state_dict,
    vtts_state_dict,
)
from visual_onoma_to_wave_tpu_torch.models import VTTS, MelGANGenerator, get_vocoder
from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples"))
import export_demo_for_torch as export  # noqa: E402
from test_torch_layers import init_random  # noqa: E402

TINY = dict(ngf=8, ratios=(8, 8, 2, 2))


def _jax_tiny(rng, T=6):
    jg = jmelgan.MelGANGenerator(**TINY)
    return jg, init_random(jg, rng, jnp.zeros((1, T, 80)), scale=0.1)


@pytest.mark.parametrize("ratios", [(8, 8, 2, 2), (4, 2)], ids=["published", "short"])
def test_generator_matches_jax(ratios):
    rng = np.random.default_rng(0)
    mel = rng.normal(-2, 1, (2, 9, 80)).astype(np.float32)
    jg = jmelgan.MelGANGenerator(ngf=8, ratios=ratios)
    variables = init_random(jg, rng, jnp.asarray(mel), scale=0.1)
    ref = np.asarray(jg.apply(variables, jnp.asarray(mel)))
    tg = MelGANGenerator(ngf=8, ratios=ratios).eval()
    tg.load_state_dict(melgan_state_dict(jax.tree.map(np.asarray, variables)))   # strict
    with torch.no_grad():
        out = tg(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, 9 * int(np.prod(ratios)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_bridge_round_trip():
    """convert_melgan_state_dict(melgan_state_dict(p)) == p."""
    _, tree = _jax_tiny(np.random.default_rng(1))
    sd = {k: v.numpy() for k, v in melgan_state_dict(tree).items()}
    back = jmelgan.convert_melgan_state_dict(sd, ratios=TINY["ratios"])
    got, want = flatten_tree(jax.tree.map(np.asarray, back)), flatten_tree(tree["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert all(torch.equal(a, b) for a, b in zip(melgan_state_dict(tree).values(),
                                                  vocoder_state_dict("MelGAN", tree).values()))


def test_bridge_raises_on_unknown_leaves_and_odd_ratios():
    _, tree = _jax_tiny(np.random.default_rng(2))
    tree["params"]["stray"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="unmapped"):
        melgan_state_dict(tree)
    with pytest.raises(ValueError, match="even"):
        MelGANGenerator(ratios=(8, 3))


def test_get_vocoder_builds_melgan_at_the_published_widths():
    g = get_vocoder("MelGAN")
    assert isinstance(g, MelGANGenerator) and g.total_upsample == 256
    assert g.model[1].out_channels == 512 and g.model[24].in_channels == 32


def test_fused_step_divides_by_ln10_as_the_jax_package():
    """A MelGAN synthesizer's waveform: the port's fused step against JAX
    make_fused_infer(..., is_melgan=True), on the demo acoustic model."""
    g = dict(np.load(export.OUT / "golden.npz"))
    batch = {k: g[k] for k in ("audiotypes", "texts", "src_lens", "image_cells")}
    jg, vparams = _jax_tiny(np.random.default_rng(3))
    jsynth = jsynthesis.Synthesizer.from_checkpoint(export.demo_config(),
                                                    acoustic=str(export.DEMO / "acoustic"),
                                                    mesh=None)
    variables = {"params": jsynth.state.params, "batch_stats": jsynth.state.batch_stats}
    ref = jsynthesis.make_fused_infer(jsynth.model, jg, True, is_melgan=True)(
        variables, vparams, {k: jnp.asarray(v) for k, v in batch.items()},
        e_control=jnp.asarray(g["e_control"]), d_control=jnp.asarray(g["d_control"]))

    cfg = export.port_demo_config()
    from visual_onoma_to_wave_tpu_torch.config import DatasetMetadata
    model = VTTS.from_config(cfg, DatasetMetadata.load(cfg.path.preprocessed), n_vocab=12).eval()
    model.load_state_dict(vtts_state_dict(load_npz(export.OUT / "acoustic.npz")))
    gen = MelGANGenerator(**TINY).eval()
    gen.load_state_dict(melgan_state_dict(jax.tree.map(np.asarray, vparams)))
    out = make_fused_infer(model, gen)({k: torch.from_numpy(v) for k, v in batch.items()},
                                       e_control=torch.from_numpy(g["e_control"]),
                                       d_control=torch.from_numpy(g["d_control"]))
    np.testing.assert_array_equal(out["mel_lens"].numpy(), np.asarray(ref["mel_lens"]))
    np.testing.assert_allclose(out["wav"].numpy(), np.asarray(ref["wav"]), rtol=0, atol=1e-5)
    with torch.no_grad():
        undivided = gen(out["postnet_mel"]).numpy()
    assert np.abs(undivided - np.asarray(ref["wav"])).max() > 1e-3   # the scale matters
