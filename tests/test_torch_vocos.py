"""The Vocos vocoder of the PyTorch port against the JAX package, on the CPU.

Inputs and weights are made with numpy from a seed and given to both
packages. The JAX Pallas kernels run in interpret mode, as the JAX package's
own tests run them (tests/test_pallas_convnext.py); the port's wrappers take
their plain versions for CPU tensors. Tolerances, float32 on both sides:

* `istft_overlap_add`: 1e-6 absolute (outputs of O(0.1), one fp32 product
  with 1026 terms against the JAX package's Precision.HIGHEST product);
* one ConvNeXt block: 2e-5 absolute, the JAX kernel's own bound against its
  module (tests/test_pallas_convnext.py:38); the trunk of 3 blocks: 5e-5
  (:101); bf16: within 0.03 of max |JAX| (:49);
* the generator and `apply_fused`: within 5e-5 of max |JAX| (:104-119);
* the demo Vocos golden: durations and mel lengths exact, mel 1e-4 and
  waveform 1e-5 absolute, as the HiFi-GAN golden (test_torch_synthesis.py).
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
from visual_onoma_to_wave_tpu.models import vocos as jvocos
from visual_onoma_to_wave_tpu.ops import pallas_convnext
from visual_onoma_to_wave_tpu_torch.bridge import (
    flatten_tree,
    load_npz,
    vocoder_state_dict,
    vocos_state_dict,
)
from visual_onoma_to_wave_tpu_torch.models import VocosGenerator, get_vocoder
from visual_onoma_to_wave_tpu_torch.models.istftnet import istft_overlap_add
from visual_onoma_to_wave_tpu_torch.models.vocos import ConvNeXtBlock, apply_fused
from visual_onoma_to_wave_tpu_torch.ops.convnext import (
    convnext_block_reference,
    convnext_trunk_reference,
)
from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples"))
import export_demo_for_torch as export  # noqa: E402
from test_torch_layers import init_random  # noqa: E402

BLOCK_ORDER = ("dwconv_w", "dwconv_b", "norm_scale", "norm_bias", "pw1_w", "pw1_b", "pw2_w",
               "pw2_b", "gamma")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _block_params(rng, C=128, M=256, T=32, gelu_approximate=True):
    jm = jvocos.ConvNeXtBlock(dim=C, intermediate_dim=M, layer_scale_init=0.25,
                              gelu_approximate=gelu_approximate)
    x = rng.normal(size=(2, T, C)).astype(np.float32)
    return jm, init_random(jm, rng, x)["params"], x


def _of_scale(out, ref) -> float:
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-3))


@pytest.mark.parametrize("n_fft", [1024, 16])
def test_istft_overlap_add_matches_jax(n_fft):
    frames = np.random.default_rng(n_fft).normal(size=(2, 12, n_fft + 2)).astype(np.float32)
    ref = np.asarray(jistftnet.istft_overlap_add(jnp.asarray(frames), n_fft))
    out = istft_overlap_add(torch.from_numpy(frames), n_fft).numpy()
    assert out.shape == ref.shape == (2, 12 * n_fft // 4)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


def test_block_reference_matches_jax_kernel():
    _, p, x = _block_params(np.random.default_rng(0))
    ref = np.asarray(pallas_convnext.convnext_block(
        jnp.asarray(x), *(p[k] for k in BLOCK_ORDER), interpret=True))
    out = convnext_block_reference(torch.from_numpy(x), *(_t(p[k]) for k in BLOCK_ORDER))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize("T", [32, 20], ids=["T32", "T20-ragged"])
@pytest.mark.parametrize("gelu_approximate", [True, False], ids=["tanh", "erf"])
def test_block_module_matches_jax(gelu_approximate, T):
    """T 20 is refused by the JAX kernel (T % 16) and served by the port's."""
    jm, p, x = _block_params(np.random.default_rng(1), T=T, gelu_approximate=gelu_approximate)
    ref = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    tm = ConvNeXtBlock(128, 256, layer_scale_init=0.25, gelu_approximate=gelu_approximate)
    tm.load_state_dict({k: _t(v) for k, v in p.items()})
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


def test_trunk_reference_matches_jax_kernel():
    rng = np.random.default_rng(2)
    blocks = [_block_params(rng)[1] for _ in range(3)]
    x = rng.normal(size=(2, 32, 128)).astype(np.float32)
    stacked = [np.stack([np.asarray(p[k]) for p in blocks]) for k in BLOCK_ORDER]
    ref = np.asarray(pallas_convnext.convnext_trunk(
        jnp.asarray(x), *map(jnp.asarray, stacked), interpret=True))
    out = convnext_trunk_reference(torch.from_numpy(x), *map(_t, stacked)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-5)


def test_bf16_block_within_scale_of_jax_kernel():
    _, p, x = _block_params(np.random.default_rng(3))
    ref = np.asarray(pallas_convnext.convnext_block(
        jnp.asarray(x, jnp.bfloat16), *(p[k] for k in BLOCK_ORDER), interpret=True), np.float32)
    out = convnext_block_reference(torch.from_numpy(x).bfloat16(),
                                   *(_t(p[k]) for k in BLOCK_ORDER))
    assert out.dtype == torch.bfloat16
    assert _of_scale(out.float().numpy(), ref) < 0.03


@pytest.mark.parametrize("T", [32, 20], ids=["T32", "T20-ragged"])
def test_generator_and_apply_fused_match_jax(T):
    """gen(mel) and apply_fused against the JAX gen.apply and, where the
    JAX kernel takes T (T % 16 == 0), the JAX apply_fused."""
    rng = np.random.default_rng(4)
    mel = rng.normal(-1, 1, (2, T, 80)).astype(np.float32)
    jg = jvocos.VocosGenerator(dim=128, intermediate_dim=256, num_layers=2)
    variables = init_random(jg, rng, jnp.asarray(mel), scale=0.1)
    ref = np.asarray(jg.apply(variables, jnp.asarray(mel)))
    refs = [ref]
    if T % 16 == 0:
        refs.append(np.asarray(jvocos.apply_fused(jg, variables, jnp.asarray(mel),
                                                  interpret=True)))
    tg = VocosGenerator(dim=128, intermediate_dim=256, num_layers=2)
    tg.load_state_dict(vocos_state_dict(jax.tree.map(np.asarray, variables)))
    with torch.no_grad():
        outs = [tg(torch.from_numpy(mel)).numpy(), apply_fused(tg, torch.from_numpy(mel)).numpy()]
    assert outs[0].shape == ref.shape == (2, T * 256)
    for out in outs:
        for r in refs:
            assert _of_scale(out, r) < 5e-5


@pytest.mark.parametrize("kw", [{}, {"dim": 128, "intermediate_dim": 384, "num_layers": 4},
                                {"num_layers": 2, "embed_kernel_size": 5, "istft_n_fft": 16}],
                         ids=["published", "demo", "small-head"])
def test_receptive_halo_frames_equal_jax(kw):
    assert VocosGenerator(**kw).receptive_halo_frames() == \
        jvocos.VocosGenerator(**kw).receptive_halo_frames()


def test_get_vocoder_builds_vocos_from_the_demo_config():
    m = export.demo_config("config_vocos.json").model
    gen = get_vocoder(m.vocoder_model, **dict(m.vocoder_kwargs), fused_kernel=True,
                      head_precision="high")
    assert isinstance(gen, VocosGenerator) and len(gen.blocks) == 4
    assert tuple(gen.blocks[0].pw1_w.shape) == (128, 384) and gen.total_upsample == 256
    # every family is ported: BigVGAN builds its base preset
    big = get_vocoder("BigVGAN")
    assert type(big).__name__ == "BigVGANGenerator" and big.upsample_initial_channel == 512


def test_vocos_state_dict_consumes_every_leaf_and_raises_on_unknown():
    tree = load_npz(export.OUT / "vocoder_vocos.npz")
    sd = vocos_state_dict(tree)
    assert len(sd) == len(flatten_tree(tree))
    m = export.demo_config("config_vocos.json").model
    get_vocoder(m.vocoder_model, **dict(m.vocoder_kwargs)).load_state_dict(sd)   # strict
    assert all(torch.equal(a, b) for a, b in zip(sd.values(),
                                                  vocoder_state_dict("Vocos", tree).values()))
    for stray in ({"params": {**tree["params"], "stray": np.zeros(1, np.float32)}},
                  {"params": {**tree["params"], "block_0": {**tree["params"]["block_0"],
                                                            "odd": np.zeros(1, np.float32)}}},
                  {**tree, "batch_stats": {"x": np.zeros(1, np.float32)}}):
        with pytest.raises(ValueError, match="unknown Vocos leaf"):
            vocos_state_dict(stray)
    # a Vocos tree is no BigVGAN tree: its first leaf is unknown there
    with pytest.raises(ValueError, match="unknown BigVGAN leaf"):
        vocoder_state_dict("BigVGAN", tree)


def test_committed_vocos_npz_equals_export():
    """examples/checkpoints/demo/torch/vocoder_vocos.npz is what the export
    script writes from the orbax checkpoint now."""
    got = flatten_tree(load_npz(export.OUT / "vocoder_vocos.npz"))
    want = flatten_tree(export.weight_trees(("vocoder_vocos",))["vocoder_vocos"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def golden_vocos():
    return dict(np.load(export.OUT / "golden_vocos.npz"))


def test_synthesizer_reproduces_vocos_golden(golden_vocos):
    synth = Synthesizer.from_checkpoint(export.demo_config("config_vocos.json"),
                                        str(export.OUT / "acoustic.npz"),
                                        str(export.OUT / "vocoder_vocos.npz"), device="cpu")
    seen = {}
    run = synth._run

    def spy(batch, e_ctl, d_ctl):
        seen.update(batch, e_control=e_ctl, d_control=d_ctl)
        out = run(batch, e_ctl, d_ctl)
        seen.update(out)
        return out

    synth._run = spy
    texts, types, rates, e, d = zip(*export.GOLDEN_REQUESTS)
    results = synth.synthesize_batch(list(texts), list(types), width_rates=list(rates),
                                     e_control=list(e), d_control=list(d))
    for k in export.GOLDEN_INPUTS + ("duration_rounded", "mel_lens"):
        np.testing.assert_array_equal(seen[k], golden_vocos[k], err_msg=k)
    for k, tol in (("postnet_mel", 1e-4), ("wav", 1e-5)):
        np.testing.assert_allclose(seen[k], golden_vocos[k], rtol=0, atol=tol, err_msg=k)
    for i, r in enumerate(results):
        assert r.wav.shape == (golden_vocos["mel_lens"][i] * 256,) and np.isfinite(r.wav).all()


def test_vocos_golden_still_matches_the_jax_package(golden_vocos):
    """golden_vocos.npz is what the JAX package serves now (XLA CPU, float32;
    1e-5 / 1e-6 absolute for a different CPU's vector code)."""
    now = export.golden("config_vocos.json", "vocoder_vocos")
    assert sorted(now) == sorted(golden_vocos)
    for k in golden_vocos:
        if golden_vocos[k].dtype.kind == "f" and k not in export.GOLDEN_INPUTS:
            tol = 1e-5 if k == "postnet_mel" else 1e-6
            np.testing.assert_allclose(now[k], golden_vocos[k], rtol=0, atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(now[k], golden_vocos[k], err_msg=k)
