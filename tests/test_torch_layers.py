"""PyTorch port layers against the JAX modules they replace, at small widths.

Inputs and parameters come from numpy seeds and go through both the JAX
module (CPU) and its port in `visual_onoma_to_wave_tpu_torch` (CPU tensors,
so attention takes its plain PyTorch version). Parameters are randomized
leaf by leaf (LayerNorm scales, BatchNorm statistics included) and carried
over by the port's weight bridge. Tolerance: both sides compute in float32
and differ only in summation order, so 1e-5 absolute on O(1) activations.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu.models import layers as jl
from visual_onoma_to_wave_tpu.models.variance_adaptor import VarianceAdaptor as JVarianceAdaptor
from visual_onoma_to_wave_tpu.models.vfe import VisualFeatureExtractor as JVFE
from visual_onoma_to_wave_tpu.ops import length_regulator as jlr
from visual_onoma_to_wave_tpu_torch.bridge import vtts_state_dict
from visual_onoma_to_wave_tpu_torch.models import layers as tl
from visual_onoma_to_wave_tpu_torch.models.variance_adaptor import VarianceAdaptor
from visual_onoma_to_wave_tpu_torch.models.vfe import VisualFeatureExtractor
from visual_onoma_to_wave_tpu_torch.ops import length_regulator as tlr

ATOL = 1e-5


def init_random(module, rng, *args, scale: float = 0.3, **kwargs):
    """The module's variables tree (shapes traced, nothing compiled) filled
    with seeded values: normal(0, scale), BatchNorm variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))

    def leaf(path, x):
        if "'var'" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return rng.normal(0.0, scale, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def port(module: torch.nn.Module, variables, scope: str = "", prefix: str = ""):
    """Load JAX `variables` into `module` through the bridge. `scope` nests the
    tree under a flax module name the bridge renames (e.g. "postnet"); the
    resulting torch `prefix` is stripped."""
    tree = {k: ({scope: v} if scope else v) for k, v in variables.items()}
    sd = vtts_state_dict(jax.tree.map(np.asarray, tree))
    module.load_state_dict({k.removeprefix(prefix): v for k, v in sd.items()})
    return module.eval()


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


def close(port_out: torch.Tensor, jax_out, atol: float = ATOL) -> None:
    np.testing.assert_allclose(port_out.detach().numpy(), np.asarray(jax_out), rtol=0, atol=atol)


def pad_mask(lens, T) -> np.ndarray:
    return np.arange(T)[None, :] >= np.asarray(lens)[:, None]


def test_sinusoid_table_is_the_reference():
    np.testing.assert_array_equal(tl.sinusoid_position_table(37, 16),
                                  jl.sinusoid_position_table(37, 16))


def test_positionwise_feed_forward():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 11, 16)).astype(np.float32)
    jm = jl.PositionwiseFeedForward(16, 32, (9, 1))
    v = init_random(jm, rng, x, True)
    ref = jm.apply(v, x, True)
    close(port(tl.PositionwiseFeedForward(16, 32, (9, 1)), v)(t(x)), ref)


@pytest.mark.parametrize("lens", [(11, 11), (11, 4), (7, 0)])
def test_fft_block(lens):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 32)).astype(np.float32)
    mask = pad_mask(lens, 11)
    jm = jl.FFTBlock(32, 2, 16, 16, 48, (9, 1))
    v = init_random(jm, rng, x, mask, None, True)
    ref = jm.apply(v, x, mask, None, True)
    out = port(tl.FFTBlock(32, 2, 16, 16, 48, (9, 1)), v)(t(x), t(mask))
    close(out, ref)
    assert not out[t(mask)].any()   # padding rows are zeroed


def test_variance_predictor():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 9, 16)).astype(np.float32)
    mask = pad_mask((9, 5, 1), 9)
    jm = jl.VariancePredictor(24, 3)
    v = init_random(jm, rng, x, mask, True)
    out = port(tl.VariancePredictor(16, 24, 3), v, "duration_predictor",
               "duration_predictor.")(t(x), t(mask))
    close(out, jm.apply(v, x, mask, True))


def test_postnet_batchnorm_eval():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 13, 8)).astype(np.float32)
    jm = jl.PostNet(n_mel_channels=8, embedding_dim=16)
    v = init_random(jm, rng, x, True)
    out = port(tl.PostNet(8, 16), v, "postnet", "postnet.")(t(x))
    close(out, jm.apply(v, x, True), atol=1e-4)   # 5 convs deep, O(10) values


@pytest.mark.parametrize("channels", [1, 3])
def test_visual_feature_extractor(channels):
    """Gray-scale and RGB-scale cells; RGB exercises the bridge's reorder of
    the bridge Dense rows from NHWC to the NCHW flatten."""
    rng = np.random.default_rng(4)
    cells = rng.uniform(0, 1, (2, 3, 8, 12)).astype(np.float32)
    jm = JVFE(embed_dim=16, num_convolutions=2, channels=channels)
    v = init_random(jm, rng, cells, True)
    tm = VisualFeatureExtractor(16, (8, 12), num_convolutions=2, channels=channels)
    out = port(tm, v, "vfe", "encoder.VisualFeatureExtractor.")(t(cells))
    close(out, jm.apply(v, cells, True), atol=1e-4)


def test_length_regulator():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 5, 4)).astype(np.float32)
    d = np.array([[2, 0, 3, 1, 0], [0, 0, 0, 0, 0], [9, 9, 9, 9, 9]], np.int32)
    ref, ref_len = jlr.length_regulate(x, d, 20)     # item 2 overflows: clamped
    out, mel_len = tlr.length_regulate(t(x), t(d), 20)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(ref_len))
    lens = np.array([3, 0, 7], np.int32)
    np.testing.assert_array_equal(tlr.get_mask_from_lengths(t(lens), 7).numpy(),
                                  np.asarray(jlr.get_mask_from_lengths(jnp.asarray(lens), 7)))
    vals = rng.normal(size=5).astype(np.float32)
    np.testing.assert_array_equal(
        tlr.expand_char_to_frame(t(vals), t(d[0]), 8).numpy(),
        np.asarray(jlr.expand_char_to_frame(vals, d[0], 8)))


ENERGY_STATS = (-1.2, 1.8, 0.3, 1.4)


def _adaptors(rng, x, mask, **kw):
    jm = JVarianceAdaptor(hidden=16, n_bins=16, filter_size=16, energy_stats=ENERGY_STATS,
                          max_mel_len=40, **kw)
    v = init_random(jm, rng, x, mask)
    # log-durations ~ log(4 + 1): a few frames per character
    dp = v["params"]["duration_predictor"]["linear_layer"]
    dp["kernel"] = dp["kernel"] * 0.1
    dp["bias"] = jnp.full_like(dp["bias"], np.log(5.0))
    tm = VarianceAdaptor(hidden=16, n_bins=16, filter_size=16, energy_stats=ENERGY_STATS,
                         max_mel_len=40, **kw)
    return jm, v, port(tm, v, "variance_adaptor", "variance_adaptor.")


@pytest.mark.parametrize("controls", [
    (1.0, 1.0),
    (np.array([1.3, 0.6, 1.0], np.float32), np.array([1.0, 1.5, 0.7], np.float32)),
], ids=["scalar", "per-item"])
def test_variance_adaptor(controls):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 6, 16)).astype(np.float32)
    mask = pad_mask((6, 4, 2), 6)
    jm, v, tm = _adaptors(rng, x, mask, is_kurtosis=True)
    e, d = controls
    ref = jm.apply(v, x, mask, e_control=e, d_control=d)
    out = tm(t(x), t(mask), e_control=e if np.isscalar(e) else t(e),
             d_control=d if np.isscalar(d) else t(d))
    names = ("x", "energy", "kurtosis", "log_d", "duration_rounded", "mel_len", "mel_mask")
    for name, o, r in zip(names, out, ref):
        if name in ("duration_rounded", "mel_len", "mel_mask"):
            np.testing.assert_array_equal(o.detach().numpy(), np.asarray(r), err_msg=name)
        else:
            close(o, r)


def test_variance_adaptor_bucketize_edges():
    """Energy predictions exactly on bin boundaries take the same bucket as
    the reference's searchsorted(side='left'), with the control applied."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 4, 16)).astype(np.float32)
    mask = pad_mask((4, 3), 4)
    for edge in (3, 0, 14):
        jm, v, tm = _adaptors(rng, x, mask)
        ep = v["params"]["energy_predictor"]["linear_layer"]
        bins = np.linspace(ENERGY_STATS[0], ENERGY_STATS[1], 15).astype(np.float32)
        ep["kernel"] = jnp.zeros_like(ep["kernel"])
        ep["bias"] = jnp.full_like(ep["bias"], (bins[edge] - ENERGY_STATS[2]) / ENERGY_STATS[3])
        tm = port(tm, v, "variance_adaptor", "variance_adaptor.")
        ref = jm.apply(v, x, mask)
        out = tm(t(x), t(mask))
        close(out[0], ref[0])
        close(out[1], ref[1])


@pytest.mark.parametrize("p,shape", [(0.2, (4, 37, 16)), (0.5, (2, 80, 9)), (0.1, (3, 5))])
def test_dropout_masks_are_the_input_device_draws_bit_for_bit(p, shape):
    """The mask is drawn on the generator's device and moved to the input's
    (`Dropout.keep_mask`). With a generator on the input's device that is the
    draw made on the input's device, `torch.rand(x.shape, generator, device=
    x.device) >= p`, bit for bit and call after call; without a generator,
    the global RNG's draw on the input's device."""
    x = torch.randn(shape)
    d = tl.Dropout(p).train()
    d.generator = torch.Generator().manual_seed(7)
    ref = torch.Generator().manual_seed(7)
    for _ in range(3):
        want = torch.rand(x.shape, generator=ref, device=x.device) >= p
        got = d.keep_mask(x)
        assert got.device == x.device and got.dtype == torch.bool
        assert torch.equal(got, want)
    out = d(x)
    assert torch.equal(out, torch.where(torch.rand(x.shape, generator=ref) >= p,
                                        x / (1.0 - p), 0.0))
    d.generator = None
    torch.manual_seed(3)
    a = d(x)
    torch.manual_seed(3)
    assert torch.equal(a, torch.where(torch.rand(x.shape) >= p, x / (1.0 - p), 0.0))
