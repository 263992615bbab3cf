"""The BigVGAN generator of the PyTorch port against the JAX package, on the CPU.

Inputs and weights are made with numpy from a seed; the JAX modules get the
weights as they are and the port's through `bridge.bigvgan_state_dict`. No
BigVGAN checkpoint is published among the reference's artifacts, so the
generators are held to each other on random weights. Tolerances, float32
on both sides, stated before the runs:

* the anti-aliasing filter: bit-equal to the reference's, and symmetric
  (the port's transposed conv relies on it in place of the reference's
  flip-free correlation);
* the resamplers and snake / snake-beta: 1e-6 absolute (inputs O(1));
* `AMPBlock1` and the generator: 1e-5 absolute, at weights of scale 0.1,
  where the waveform stays O(0.1) (no tanh saturation).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu.models import bigvgan as jbigvgan
from visual_onoma_to_wave_tpu_torch.bridge import (
    bigvgan_state_dict,
    flatten_tree,
    vocoder_state_dict,
)
from visual_onoma_to_wave_tpu_torch.models import BigVGANGenerator, get_vocoder
from visual_onoma_to_wave_tpu_torch.models import bigvgan as tbigvgan
from test_torch_layers import init_random  # noqa: E402

# tests/test_bigvgan.py's TINY, and the large preset's plan at tiny widths
TINY = dict(upsample_initial_channel=16, n_mels=8, resblock_kernel_sizes=(3,),
            resblock_dilations=((1, 2),))
TINY_LARGE = dict(jbigvgan.BIGVGAN_PRESETS["large"], **dict(TINY, upsample_initial_channel=64))


def bct(x: np.ndarray) -> torch.Tensor:
    """(B, T, C) numpy -> (B, C, T) contiguous tensor."""
    return torch.from_numpy(x).transpose(1, 2).contiguous()


def ported(variables, **kw) -> BigVGANGenerator:
    gen = BigVGANGenerator(**kw).eval()
    gen.load_state_dict(bigvgan_state_dict(jax.tree.map(np.asarray, variables)))   # strict
    return gen


@pytest.mark.parametrize("cutoff,half_width,k", [(0.25, 0.3, 12), (0.25, 0.3, 13),
                                                 (0.1, 0.05, 8), (0.2, 0.01, 4)],
                         ids=["aa", "odd", "mid-attenuation", "no-window"])
def test_kaiser_sinc_filter_is_bit_equal(cutoff, half_width, k):
    got = tbigvgan.kaiser_sinc_filter1d(cutoff, half_width, k)
    want = jbigvgan.kaiser_sinc_filter1d(cutoff, half_width, k)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_aa_filters_are_the_references_and_symmetric():
    h = jbigvgan.kaiser_sinc_filter1d(0.25, 0.3, jbigvgan._AA_KERNEL)
    assert tbigvgan.AA_KERNEL == jbigvgan._AA_KERNEL
    np.testing.assert_array_equal(tbigvgan.DOWN_FILTER, h)
    np.testing.assert_array_equal(tbigvgan.UP_FILTER, 2.0 * h)
    # the upsampler's transposed conv equals the reference's correlation
    # only for a symmetric filter
    np.testing.assert_array_equal(tbigvgan.UP_FILTER, tbigvgan.UP_FILTER[::-1])
    np.testing.assert_array_equal(tbigvgan.DOWN_FILTER, tbigvgan.DOWN_FILTER[::-1])


@pytest.mark.parametrize("T", [37, 1, 64])
def test_resamplers_match_jax(T):
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, T, 5)).astype(np.float32)
    up = tbigvgan.upsample2(bct(x), tbigvgan.depthwise_filter(tbigvgan.UP_FILTER, 5))
    ref_up = np.asarray(jbigvgan.upsample2(jnp.asarray(x)))
    assert up.shape == (2, 5, 2 * T)
    np.testing.assert_allclose(up.transpose(1, 2).numpy(), ref_up, rtol=0, atol=1e-6)
    x2 = rng.normal(size=(2, 2 * T, 5)).astype(np.float32)
    dn = tbigvgan.downsample2(bct(x2), tbigvgan.depthwise_filter(tbigvgan.DOWN_FILTER, 5))
    ref_dn = np.asarray(jbigvgan.downsample2(jnp.asarray(x2)))
    assert dn.shape == (2, 5, T)
    np.testing.assert_allclose(dn.transpose(1, 2).numpy(), ref_dn, rtol=0, atol=1e-6)


def test_snake_and_snake_beta_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 2, (2, 50, 6)).astype(np.float32)
    la, lb = (rng.normal(0, 0.5, 6).astype(np.float32) for _ in range(2))
    t = {k: torch.from_numpy(v) for k, v in (("la", la), ("lb", lb))}
    np.testing.assert_allclose(
        tbigvgan.snake(bct(x), t["la"]).transpose(1, 2).numpy(),
        np.asarray(jbigvgan.snake(jnp.asarray(x), jnp.asarray(la))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tbigvgan.snake_beta(bct(x), t["la"], t["lb"]).transpose(1, 2).numpy(),
        np.asarray(jbigvgan.snake_beta(jnp.asarray(x), jnp.asarray(la), jnp.asarray(lb))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("activation", ["snakebeta", "snake"])
@pytest.mark.parametrize("anti_aliased", [True, False], ids=["aa", "no-aa"])
def test_amp_block_matches_jax(anti_aliased, activation):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 29, 8)).astype(np.float32)
    jblock = jbigvgan.AMPBlock1(8, 5, (1, 3), activation=activation, anti_aliased=anti_aliased)
    variables = init_random(jblock, rng, jnp.asarray(x), scale=0.1)
    ref = np.asarray(jblock.apply(variables, jnp.asarray(x)))
    # the bridge maps a generator's tree: nest the block as amp_0_0
    sd = bigvgan_state_dict({"params": {"amp_0_0": jax.tree.map(np.asarray,
                                                                variables["params"])}})
    block = tbigvgan.AMPBlock1(8, 5, (1, 3), activation, anti_aliased).eval()
    block.load_state_dict({k.removeprefix("resblocks.0."): v for k, v in sd.items()})
    with torch.no_grad():
        out = block(bct(x)).transpose(1, 2).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw", [TINY, dict(TINY, anti_aliased=False), TINY_LARGE,
                                dict(TINY, activation="snake")],
                         ids=["tiny", "tiny-no-aa", "tiny-large-plan", "tiny-snake"])
def test_generator_matches_jax(kw):
    rng = np.random.default_rng(7)
    mel = rng.normal(size=(2, 6, 8)).astype(np.float32)
    jgen = jbigvgan.BigVGANGenerator(**kw)
    variables = init_random(jgen, rng, jnp.asarray(mel), scale=0.1)
    ref = np.asarray(jgen.apply(variables, jnp.asarray(mel)))
    gen = ported(variables, **kw)
    with torch.no_grad():
        out = gen(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (2, 6 * 256) and gen.total_upsample == jgen.total_upsample
    assert 0.01 < np.abs(ref).max() < 0.9          # not saturated by the tanh
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_initial_distributions_and_filter_buffers():
    """Weights N(0, 0.01), biases and log-alpha / log-beta 0, as the
    reference's initialisers; the AA filters are (C, 1, K) contiguous
    buffers that move with the module and stay out of the state_dict. The
    mean is held to 4 standard errors of n draws (conv_post has 224)."""
    torch.manual_seed(0)
    gen = BigVGANGenerator()
    for name, p in gen.named_parameters():
        p = p.detach()
        if name.endswith(".weight"):
            assert abs(float(p.std()) - 0.01) < 2e-3, name
            assert abs(float(p.mean())) < 4 * 0.01 / p.numel() ** 0.5, name
        else:
            assert not p.any(), name
    filters = [(n, b) for n, b in gen.named_buffers() if n.endswith(("w_up", "w_down"))]
    # 4 stages x 3 branches x 3 dilations x 2 sites, and act_post; up and down
    assert len(filters) == 2 * (4 * 3 * 3 * 2 + 1)
    for name, b in filters:
        assert b.is_contiguous() and b.shape[1:] == (1, tbigvgan.AA_KERNEL), name
    assert not any(k.endswith(("w_up", "w_down")) for k in gen.state_dict())
    no_aa = BigVGANGenerator(anti_aliased=False)
    assert not list(no_aa.buffers())
    assert sorted(no_aa.state_dict()) == sorted(gen.state_dict())


def test_parameter_counts_equal_jax():
    mel = jnp.zeros((1, 4, 80), jnp.float32)
    for preset in ("base", "large"):
        jgen = jbigvgan.BigVGANGenerator(**jbigvgan.BIGVGAN_PRESETS[preset])
        shapes = jax.eval_shape(lambda g=jgen: g.init(jax.random.PRNGKey(0), mel))
        n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
        gen = get_vocoder("BigVGAN-large" if preset == "large" else "BigVGAN")
        assert sum(p.numel() for p in gen.parameters()) == n_jax, preset


def test_get_vocoder_presets_and_overrides():
    base = get_vocoder("BigVGAN")
    assert isinstance(base, BigVGANGenerator)
    assert base.upsample_initial_channel == 512 and base.upsample_rates == (8, 8, 2, 2)
    assert base.activation == "snakebeta" and base.anti_aliased
    assert isinstance(get_vocoder("bigvgan_base"), BigVGANGenerator)
    large = get_vocoder("BigVGAN-large")
    assert large.upsample_initial_channel == 1536 and large.total_upsample == 256
    assert large.upsample_rates == (4, 4, 2, 2, 2, 2)
    small = get_vocoder("bigvgan", upsample_initial_channel=32, anti_aliased=False)
    assert small.upsample_initial_channel == 32 and not small.anti_aliased


def test_bridge_consumes_every_leaf_and_raises_on_unknown():
    rng = np.random.default_rng(9)
    mel = jnp.asarray(rng.normal(size=(1, 4, 8)).astype(np.float32))
    for kw in (TINY, dict(TINY, activation="snake"), TINY_LARGE):
        tree = jax.tree.map(np.asarray, init_random(jbigvgan.BigVGANGenerator(**kw), rng, mel))
        sd = vocoder_state_dict("BigVGAN", tree)
        assert len(sd) == len(flatten_tree(tree))
        BigVGANGenerator(**kw).load_state_dict(sd)      # strict
    for stray in ({"params": {**tree["params"], "stray_w": np.zeros(1, np.float32)}},
                  {"params": {**tree["params"], "amp_0_0": {**tree["params"]["amp_0_0"],
                                                            "odd": np.zeros(1, np.float32)}}},
                  {**tree, "batch_stats": {"x": np.zeros(1, np.float32)}}):
        with pytest.raises(ValueError, match="unknown BigVGAN leaf"):
            bigvgan_state_dict(stray)
