"""bf16 compute in the port against the JAX package's bf16 modules, on the CPU.

The JAX modules take `dtype=jnp.bfloat16` (parameters fp32; each linear and
conv casts its weight and input, its product sums in fp32 and is rounded
once, its bias added in bf16); the port's take `dtype=torch.bfloat16`
(`precision.at_dtype`). Weights and inputs are made with numpy from a seed
and bridged by the port's converters. Tolerances:

* each module, bf16 port against bf16 JAX: 2e-2 of max |JAX output|, the
  bound of the JAX package's own bf16 attention test
  (tests/test_pallas_attention.py:35). Both round at the same points, but
  a product summed in another order can round a bf16 value the other way,
  and the step travels down the network;
* beside each of those, a control (`control`): in mean |error| over mean
  |JAX output|, the same port module in fp32 on the same weights sits at
  least CONTROL times further from JAX's bf16 output than the port's bf16
  does. The bound above is loose enough to pass an fp32 module (bf16 and
  fp32 differ by ~1e-3 to 1e-2 of max); the control is what fails if a
  module's compute dtype is dropped. It reads the mean, not the max: the
  port's bf16 and JAX's round at the same points and part only where a sum
  in another order rounds one value the other way, a few elements and what
  they reach (in the acoustic model one decoder frame, 1.5e-3 of max, as
  large as fp32's max gap), while fp32 parts from bf16 at every element.
  CONTROL is 10. Where flips compound down a deep chain of wide sums (the
  acoustic model's mel and postnet mel, iSTFTNet C8C8I at width 64: 0.3%
  of its first upsample's outputs differ by one bf16 step, a third of its
  last stage's) the fp32 twin sits only 2.3-2.7x further, and the control
  is DEEP_CONTROL = 1.5; a dropped compute dtype puts the ratio at 1;
* the slice (acoustic model with given durations, then HiFi-GAN V1):
  5e-2 of max |mel| and of max |wav|; free-running mel lengths within one
  frame per item of JAX's (a bf16 encoder feeds the fp32 duration
  predictor, and a rounded duration may land on the other integer);
* the JAX package's bf16 tests as port tests, with their bounds
  (test_hifigan.py:136, test_vocos.py:91, test_pallas_convnext.py:41 and
  :105-111, test_training.py:126, test_vocoder_training.py:522 and :562);
* invariants: fp32 modules compute bit for bit what the pre-bf16 forwards
  computed (written out here), parameters stay fp32 through a bf16 step,
  and a bf16 synthesizer exports on the CPU and serves what the live path
  serves.

`test_measured_gaps` prints each module's measured gap (`-s`).
"""
from __future__ import annotations

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from visual_onoma_to_wave_tpu.models import bigvgan as jbigvgan
from visual_onoma_to_wave_tpu.models import hifigan as jhifigan
from visual_onoma_to_wave_tpu.models import hifigan_disc as jdisc
from visual_onoma_to_wave_tpu.models import istftnet as jistftnet
from visual_onoma_to_wave_tpu.models import layers as jl
from visual_onoma_to_wave_tpu.models import vocos as jvocos
from visual_onoma_to_wave_tpu.models.vtts import VTTS as JVTTS
from visual_onoma_to_wave_tpu.ops import pallas_convnext
from visual_onoma_to_wave_tpu_torch.bridge import (
    bigvgan_state_dict,
    hifigan_state_dict,
    mpd_state_dict,
    mrd_state_dict,
    msd_state_dict,
    vocos_state_dict,
    vtts_state_dict,
)
from visual_onoma_to_wave_tpu_torch.models import (
    VTTS,
    BigVGANGenerator,
    HiFiGANGenerator,
    VocosGenerator,
    build_istftnet,
    get_vocoder,
)
from visual_onoma_to_wave_tpu_torch.models import hifigan_disc as tdisc
from visual_onoma_to_wave_tpu_torch.models import layers as tl
from visual_onoma_to_wave_tpu_torch.models.hifigan import ResBlock1
from visual_onoma_to_wave_tpu_torch.models.vocos import apply_fused
from visual_onoma_to_wave_tpu_torch.ops.convnext import convnext_block_reference
from visual_onoma_to_wave_tpu_torch.ops.mrf import (
    MRFStages,
    mrf_stage_fused,
    mrf_stage_fused_reference,
)
from visual_onoma_to_wave_tpu_torch.precision import at_dtype, compute_dtype
from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer

from test_torch_layers import init_random, pad_mask, port

BF16 = torch.bfloat16
REL = 2e-2          # one module, port bf16 vs JAX bf16, of max |JAX|
SLICE_REL = 5e-2    # the acoustic model and vocoder together
CONTROL = 10        # the fp32 twin's mean gap to JAX bf16 over the port bf16's, at least
DEEP_CONTROL = 1.5  # the same where rounding flips compound down a deep chain

# the slice at test size: the ICASSP geometry narrowed (hidden 64, 2 + 2
# blocks, dk 32) and HiFi-GAN V1's plan at 32 channels
VTTS_KW = dict(n_vocab=20, n_audiotype=3, hidden=64, encoder_layers=2, decoder_layers=2,
               n_head=2, d_inner=64, max_seq_len=32, max_mel_len=96, vp_filter=32, n_bins=16,
               postnet_dim=32, vfe_layers=2, energy_stats=(-1.0, 2.0, 0.2, 1.3),
               kurtosis_stats=(-2.0, 1.0, 0.1, 0.9))
HIFI_KW = dict(jhifigan.HIFIGAN_PRESETS["v1"], upsample_initial_channel=32)

GAPS: dict[str, float] = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gap(name: str, ours, ref) -> float:
    """max |ours - ref| / max |ref|, recorded under `name`."""
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
    g = float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-6))
    GAPS[name] = g
    return g


def mean_gap(ours, ref) -> float:
    """mean |ours - ref| / mean |ref|."""
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).mean() / max(np.abs(ref).mean(), 1e-12))


def control(name: str, ours16, ours32, ref, factor: float = CONTROL) -> None:
    """The port's bf16 output `ours16` is JAX's bf16 output `ref` and not
    fp32's: its fp32 twin's `ours32` sits at least `factor` times further
    from `ref` in `mean_gap`."""
    g16, g32 = mean_gap(ours16, ref), mean_gap(ours32, ref)
    GAPS[f"{name}_mean"], GAPS[f"{name}_fp32_twin_mean"] = g16, g32
    GAPS[f"{name}_control_ratio"] = g32 / max(g16, 1e-30)
    assert factor * g16 < g32, (name, g16, g32)


def fp32_twin(module: torch.nn.Module, make) -> torch.nn.Module:
    """`make()` (the same module built in fp32) with `module`'s weights."""
    twin = make()
    twin.load_state_dict(module.state_dict())
    return twin.train(module.training)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


def _vtts_inputs(rng, B=3, C=6):
    return dict(audiotypes=np.array([0, 2, 1], np.int32)[:B],
                texts=rng.integers(1, 21, (B, C)).astype(np.int32),
                src_lens=np.array([6, 4, 3], np.int32)[:B],
                image_cells=rng.uniform(0, 1, (B, C, 8, 12)).astype(np.float32))


def _vtts_pair(rng, inp):
    """(JAX bf16 model, its variables, the port's bf16 model with them)."""
    jm = JVTTS(**VTTS_KW, dtype=jnp.bfloat16)
    v = init_random(jm, rng, **inp, scale=0.1)
    dur = v["params"]["variance_adaptor"]["duration_predictor"]["linear_layer"]
    dur["kernel"] = dur["kernel"] * 0.1
    dur["bias"] = jnp.full_like(dur["bias"], np.log(6.0))
    tm = VTTS(**VTTS_KW, cell_hw=(8, 12), dtype=BF16)
    tm.load_state_dict(vtts_state_dict(jax.tree.map(np.asarray, v)))
    return jm, v, tm.eval()


def _hifigan_pair(rng, mel, preset: str = "v1"):
    kw = dict(jhifigan.HIFIGAN_PRESETS[preset], upsample_initial_channel=32)
    jm = jhifigan.HiFiGANGenerator(**kw, dtype=jnp.bfloat16)
    v = init_random(jm, rng, mel, scale=0.1)
    tm = HiFiGANGenerator(**kw, dtype=BF16)
    tm.load_state_dict(hifigan_state_dict(jax.tree.map(np.asarray, v)))
    return jm, v, tm.eval()


# ---------------------------------------------------------------------------
# module parity, bf16 port against bf16 JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lens", [(11, 11), (11, 4)])
def test_fft_block_bf16_matches_jax(lens):
    """Attention (projections bf16, logits and softmax fp32, P rounded to
    bf16), the conv FFN in bf16, both post-LNs fp32; the output fp32."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 64)).astype(np.float32)
    mask = pad_mask(lens, 11)
    jm = jl.FFTBlock(64, 2, 32, 32, 96, (9, 1), dtype=jnp.bfloat16)
    v = init_random(jm, rng, x, mask, None, True)
    ref = jm.apply(v, x, mask, None, True)
    tm = port(tl.FFTBlock(64, 2, 32, 32, 96, (9, 1), dtype=BF16), v)
    t32 = port(tl.FFTBlock(64, 2, 32, 32, 96, (9, 1)), v)
    with torch.no_grad():
        out, out32 = tm(t(x), t(mask)), t32(t(x), t(mask))
    assert out.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    assert gap(f"fft_block_{lens[1]}", out, ref) <= REL
    control(f"fft_block_{lens[1]}", out, out32, ref)


def test_postnet_bf16_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 13, 8)).astype(np.float32)
    jm = jl.PostNet(n_mel_channels=8, embedding_dim=16, dtype=jnp.bfloat16)
    v = init_random(jm, rng, x, True)
    with torch.no_grad():
        out = port(tl.PostNet(8, 16, dtype=BF16), v, "postnet", "postnet.")(t(x))
        out32 = port(tl.PostNet(8, 16), v, "postnet", "postnet.")(t(x))
    ref = jm.apply(v, x, True)
    assert out.dtype == torch.float32
    assert gap("postnet", out, ref) <= REL
    control("postnet", out, out32, ref)


def test_vtts_bf16_with_given_durations_matches_jax():
    rng = np.random.default_rng(0)
    inp = _vtts_inputs(rng)
    jm, v, tm = _vtts_pair(rng, inp)
    durs = rng.integers(2, 7, (3, 6)).astype(np.int32)
    energies = rng.normal(size=(3, 6)).astype(np.float32)
    kw = dict(energy_targets=energies, duration_targets=durs)
    ref = jm.apply(v, **inp, **kw, max_mel_len=48)
    t32 = fp32_twin(tm, lambda: VTTS(**VTTS_KW, cell_hw=(8, 12)))
    with torch.no_grad():
        out, out32 = (m(**{k: t(a) for k, a in inp.items()}, energy_targets=t(energies),
                        duration_targets=t(durs), max_mel_len=48) for m in (tm, t32))
    np.testing.assert_array_equal(out["mel_lens"].numpy(), np.asarray(ref["mel_lens"]))
    for k in ("mel", "postnet_mel", "log_duration_pred", "energy_pred"):
        assert out[k].dtype == torch.float32
        assert gap(f"vtts_{k}", out[k], ref[k]) <= REL, k
        control(f"vtts_{k}", out[k], out32[k], ref[k],
                CONTROL if k.endswith("_pred") else DEEP_CONTROL)


def test_vtts_bf16_free_running_lengths_within_a_frame_of_jax():
    rng = np.random.default_rng(0)
    inp = _vtts_inputs(rng)
    jm, v, tm = _vtts_pair(rng, inp)
    ref = jm.apply(v, **inp)
    with torch.no_grad():
        out = tm(**{k: t(a) for k, a in inp.items()})
    lens, ref_lens = out["mel_lens"].numpy(), np.asarray(ref["mel_lens"])
    assert np.abs(lens - ref_lens).max() <= 1, (lens, ref_lens)
    GAPS["vtts_free_running_mel_len_frames"] = float(np.abs(lens - ref_lens).max())


def test_mrf_stage_bf16_on_the_cpu_is_the_jax_resblock_chain():
    """A bf16 MRF stage on the CPU runs its ResBlock1 modules, which round
    where JAX's `_conv1d` rounds: held to JAX's three bf16 ResBlock1
    branches and their mean, the served generators' bf16 MRF stage. The
    kernel's plain version keeps the kernel's fp32 residual streams and so
    sits between JAX's bf16 chain and fp32: its gap to JAX's bf16 is
    recorded and held to REL."""
    rng = np.random.default_rng(4)
    c = 32
    x = rng.normal(0, 1, (2, 300, c)).astype(np.float32)
    blocks, outs = [], []
    for k in (3, 7, 11):
        jb = jhifigan.ResBlock1(c, k, (1, 3, 5), dtype=jnp.bfloat16)
        v = init_random(jb, rng, jnp.asarray(x, jnp.bfloat16), scale=0.05)
        outs.append(jb.apply(v, jnp.asarray(x, jnp.bfloat16)))
        tb = ResBlock1(c, k, (1, 3, 5), dtype=BF16)
        p = jax.tree.map(np.asarray, v["params"])
        with torch.no_grad():
            for i in range(3):
                for conv, name in ((tb.convs1[i], f"convs1_{i}"), (tb.convs2[i], f"convs2_{i}")):
                    conv.weight.copy_(t(p[f"{name}_w"]).permute(2, 1, 0))
                    conv.bias.copy_(t(p[f"{name}_b"]))
        blocks.append(tb)
    ref = np.asarray((outs[0] + outs[1] + outs[2]) / 3, np.float32)
    stage = torch.nn.ModuleList(blocks)
    stage32 = fp32_twin(stage, lambda: torch.nn.ModuleList(ResBlock1(c, k, (1, 3, 5))
                                                           for k in (3, 7, 11)))
    with torch.no_grad():
        xt = t(x).transpose(1, 2).contiguous().to(BF16)
        served = MRFStages()(0, stage, xt)
        chain = MRFStages()(0, stage, xt, fused=False)
        mats, biases = MRFStages.pack(stage, BF16, "cpu")[:2]
        plain = mrf_stage_fused_reference(xt, *mats, biases)
        out32 = MRFStages()(0, stage32, xt.float())
    assert served.dtype == chain.dtype == plain.dtype == BF16
    assert torch.equal(served, chain)
    assert gap("mrf_stage_modules", chain.transpose(1, 2), ref) <= REL
    control("mrf_stage_modules", chain.transpose(1, 2), out32.transpose(1, 2), ref)
    assert gap("mrf_stage_kernel_plain_version", plain.transpose(1, 2), ref) <= REL


@pytest.mark.parametrize("preset", ["v1", "v3"])
def test_hifigan_bf16_matches_jax(preset):
    rng = np.random.default_rng(1)
    mel = rng.normal(size=(2, 17, 80)).astype(np.float32)
    jm, v, tm = _hifigan_pair(rng, mel, preset)
    ref = np.asarray(jm.apply(v, mel))
    kw = dict(jhifigan.HIFIGAN_PRESETS[preset], upsample_initial_channel=32)
    t32 = fp32_twin(tm, lambda: HiFiGANGenerator(**kw))
    with torch.no_grad():
        out, out32 = tm(t(mel)), t32(t(mel))
    assert out.dtype == torch.float32
    assert gap(f"hifigan_{preset}", out, ref) <= REL
    control(f"hifigan_{preset}", out, out32, ref)


@pytest.mark.parametrize("scale", [0.05, 0.1], ids=["quiet", "loud"])
@pytest.mark.parametrize("preset", ["c8c8i", "melrate"])
def test_istftnet_bf16_matches_jax(preset, scale):
    """At weights N(0, 0.05) (outputs O(0.1), as a trained vocoder's) within
    2e-2. At N(0, 0.1) the head's exp(log-magnitude) turns bf16 rounding
    into gaps of 3-5% of outputs up to ~25 in JAX's own bf16 against its
    fp32, so there the port's bf16 is held to within 1.5x of that gap."""
    width = {"c8c8i": 64, "melrate": 32}[preset]
    outs = {}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, BF16)):
        rng = np.random.default_rng(2)
        mel = rng.normal(-1, 1, (2, 12, 80)).astype(np.float32)
        jg = jistftnet.build_istftnet(preset, upsample_initial_channel=width, dtype=jdt)
        v = init_random(jg, rng, jnp.asarray(mel), scale=scale)
        tg = build_istftnet(preset, upsample_initial_channel=width, dtype=tdt).eval()
        tg.load_state_dict(hifigan_state_dict(jax.tree.map(np.asarray, v)))
        with torch.no_grad():
            outs[tdt] = (np.asarray(jg.apply(v, jnp.asarray(mel))), tg(t(mel)))
    (ref32, out32), (ref16, out16) = outs[torch.float32], outs[BF16]
    assert out16.dtype == torch.float32
    got = gap(f"istftnet_{preset}_{scale}", out16, ref16)
    jax_own = np.abs(ref16 - ref32).max() / np.abs(ref16).max()
    GAPS[f"istftnet_{preset}_{scale}_jax_bf16_vs_f32"] = float(jax_own)
    assert got <= (REL if scale == 0.05 else 1.5 * jax_own)
    control(f"istftnet_{preset}_{scale}", out16, out32, ref16,
            DEEP_CONTROL if preset == "c8c8i" else CONTROL)


def test_vocos_bf16_matches_jax_served_form():
    """The JAX package serves Vocos with its ConvNeXt kernel
    (`fused_kernel=True`, interpret mode here); the port's `.eval()` blocks
    run B4's plain version in bf16."""
    rng = np.random.default_rng(5)
    mel = rng.normal(-1, 1, (2, 32, 80)).astype(np.float32)
    jg = jvocos.VocosGenerator(dim=128, intermediate_dim=256, num_layers=2,
                               dtype=jnp.bfloat16)
    v = jax.jit(jg.init)(jax.random.PRNGKey(0), jnp.asarray(mel))
    fused = jvocos.VocosGenerator(dim=128, intermediate_dim=256, num_layers=2,
                                  dtype=jnp.bfloat16, fused_kernel=True)
    real = pallas_convnext.convnext_block
    pallas_convnext.convnext_block = lambda *a, **k: real(*a, **k, interpret=True)
    try:
        ref = np.asarray(fused.apply(v, jnp.asarray(mel)))
    finally:
        pallas_convnext.convnext_block = real
    tg = VocosGenerator(dim=128, intermediate_dim=256, num_layers=2, dtype=BF16).eval()
    tg.load_state_dict(vocos_state_dict(jax.tree.map(np.asarray, v)))
    t32 = fp32_twin(tg, lambda: VocosGenerator(dim=128, intermediate_dim=256, num_layers=2))
    with torch.no_grad():
        out, out32 = tg(t(mel)), t32(t(mel))
        trunk = apply_fused(tg, t(mel))
    assert out.dtype == torch.float32
    assert gap("vocos", out, ref) <= REL
    assert gap("vocos_apply_fused", trunk, ref) <= REL
    control("vocos", out, out32, ref)
    control("vocos_apply_fused", trunk, out32, ref)


def test_bigvgan_bf16_matches_jax():
    rng = np.random.default_rng(6)
    kw = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
              resblock_kernel_sizes=(3,), resblock_dilations=((1, 2),))
    mel = rng.normal(size=(2, 9, 80)).astype(np.float32)
    jg = jbigvgan.BigVGANGenerator(**kw, dtype=jnp.bfloat16)
    v = init_random(jg, rng, jnp.asarray(mel), scale=0.1)
    ref = np.asarray(jg.apply(v, jnp.asarray(mel)))
    tg = BigVGANGenerator(**kw, dtype=BF16).eval()
    tg.load_state_dict(bigvgan_state_dict(jax.tree.map(np.asarray, v)))
    t32 = fp32_twin(tg, lambda: BigVGANGenerator(**kw))
    with torch.no_grad():
        out, out32 = tg(t(mel)), t32(t(mel))
    assert out.dtype == torch.float32
    assert gap("bigvgan", out, ref) <= REL
    control("bigvgan", out, out32, ref)


@pytest.mark.parametrize("kind", ["mpd", "msd", "mrd"])
def test_discriminators_bf16_match_jax(kind):
    """Logits fp32 and feature maps bf16 on both sides."""
    jcls, tcls, bridge, kw = {
        "mpd": (jdisc.MultiPeriodDiscriminator, tdisc.MultiPeriodDiscriminator, mpd_state_dict,
                dict(periods=(2, 3, 5), channels=(4, 8, 16))),
        "msd": (jdisc.MultiScaleDiscriminator, tdisc.MultiScaleDiscriminator, msd_state_dict,
                dict(n_scales=2, channels=4)),
        "mrd": (jdisc.MultiResolutionDiscriminator, tdisc.MultiResolutionDiscriminator,
                mrd_state_dict, dict(channels=4)),
    }[kind]
    rng = np.random.default_rng(7)
    y, y_hat = (rng.normal(0, 0.1, (2, 2048)).astype(np.float32) for _ in range(2))
    jm = jcls(**kw, dtype=jnp.bfloat16)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(y), jnp.asarray(y_hat))
    rs, gs, fr, fg = jm.apply(v, jnp.asarray(y), jnp.asarray(y_hat))
    tm = tcls(**kw, dtype=BF16)
    tm.load_state_dict(bridge(jax.tree.map(np.asarray, v)))
    t32 = fp32_twin(tm, lambda: tcls(**kw))

    def outputs(module, fmap_dtype, name: str) -> tuple[float, np.ndarray]:
        """The largest gap of `module`'s logits and feature maps to JAX's
        (recorded under `name`), and all of them flattened into one vector
        (JAX's layout)."""
        with torch.no_grad():
            trs, tgs, tfr, tfg = module(t(y), t(y_hat))
        worst, flat = 0.0, []
        for ours, ref in zip(trs + tgs, rs + gs):
            assert ours.dtype == torch.float32
            worst = max(worst, gap(f"{name}_logits", ours, ref))
            flat.append(ours.numpy().ravel())
        for maps, ref_maps in ((tfr, fr), (tfg, fg)):
            for m_ours, m_ref in zip(maps, ref_maps):
                for a, b in zip(m_ours, m_ref):
                    assert a.dtype == fmap_dtype
                    a = np.moveaxis(a.float().numpy(), 1, -1)
                    worst = max(worst, gap(f"{name}_fmap", a, np.asarray(b, np.float32)))
                    flat.append(a.ravel())
        return worst, np.concatenate(flat)

    ref_flat = np.concatenate([np.asarray(o, np.float32).ravel()
                               for o in (*rs, *gs, *(a for ms in (*fr, *fg) for a in ms))])
    worst, flat16 = outputs(tm, BF16, kind)
    _, flat32 = outputs(t32, torch.float32, f"{kind}_fp32_twin")
    GAPS[kind] = worst
    assert worst <= REL
    control(kind, flat16, flat32, ref_flat)


def test_slice_bf16_with_given_durations_matches_jax():
    """Acoustic model and HiFi-GAN V1, both bf16, through the port's fused
    call against the JAX modules chained: the mel and the waveform within
    5e-2 of their max."""
    rng = np.random.default_rng(8)
    inp = _vtts_inputs(rng)
    jm, v, tm = _vtts_pair(rng, inp)
    jg, gv, tg = _hifigan_pair(rng, np.zeros((1, 8, 80), np.float32))
    durs = rng.integers(3, 8, (3, 6)).astype(np.int32)
    ref = jm.apply(v, **inp, duration_targets=durs)
    ref_wav = np.asarray(jg.apply(gv, ref["postnet_mel"]))

    def with_durations(model):
        forward = model.forward
        return lambda *a, **k: forward(*a, **k, duration_targets=t(durs))

    t32 = fp32_twin(tm, lambda: VTTS(**VTTS_KW, cell_hw=(8, 12)))
    g32 = fp32_twin(tg, lambda: HiFiGANGenerator(**HIFI_KW))
    tm.forward, t32.forward = with_durations(tm), with_durations(t32)
    out = make_fused_infer(tm, tg)({k: t(a) for k, a in inp.items()})
    out32 = make_fused_infer(t32, g32)({k: t(a) for k, a in inp.items()})
    np.testing.assert_array_equal(out["mel_lens"].numpy(), np.asarray(ref["mel_lens"]))
    assert gap("slice_mel", out["postnet_mel"], ref["postnet_mel"]) <= SLICE_REL
    assert out["wav"].dtype == torch.float32
    assert gap("slice_wav", out["wav"], ref_wav) <= SLICE_REL
    control("slice_mel", out["postnet_mel"], out32["postnet_mel"], ref["postnet_mel"])
    control("slice_wav", out["wav"], out32["wav"], ref_wav)


# ---------------------------------------------------------------------------
# the JAX package's bf16 tests, on the port
# ---------------------------------------------------------------------------

def test_hifigan_bf16_close_to_f32():
    """JAX tests/test_hifigan.py:136: max error < 0.05, relative L2 < 0.05."""
    rng = np.random.default_rng(3)
    mel = t(rng.standard_normal((2, 13, 80)).astype(np.float32))
    g32 = HiFiGANGenerator(**HIFI_KW).eval()
    g16 = HiFiGANGenerator(**HIFI_KW, dtype=BF16).eval()
    g16.load_state_dict(g32.state_dict())
    with torch.no_grad():
        ref, low = g32(mel).numpy(), g16(mel)
    assert low.dtype == torch.float32
    low = low.numpy()
    assert np.abs(low - ref).max() < 0.05
    assert np.linalg.norm(low - ref) / (np.linalg.norm(ref) + 1e-9) < 0.05


def test_vocos_bf16_trunk_close_to_f32():
    """JAX tests/test_vocos.py:91: within 0.1 of max |f32|."""
    mel = t(np.random.default_rng(4).normal(-1, 1, (2, 20, 80)).astype(np.float32))
    g32 = VocosGenerator(dim=16, intermediate_dim=32, num_layers=2).eval()
    g16 = VocosGenerator(dim=16, intermediate_dim=32, num_layers=2, dtype=BF16).eval()
    g16.load_state_dict(g32.state_dict())
    with torch.no_grad():
        w32, w16 = g32(mel).numpy(), g16(mel)
    assert w16.dtype == torch.float32
    assert np.abs(w16.numpy() - w32).max() / max(np.abs(w32).max(), 1e-3) < 0.1


def test_convnext_block_bf16_within_scale_of_jax_xla_block():
    """JAX tests/test_pallas_convnext.py:41: the kernel's bf16 block within
    0.03 of the bf16 XLA block's max; here the port's plain version."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 32, 128)).astype(np.float32)
    blk = jvocos.ConvNeXtBlock(128, 256, 0.5, dtype=jnp.bfloat16)
    p = jax.jit(blk.init)(jax.random.PRNGKey(1), jnp.asarray(x, jnp.bfloat16))["params"]
    ref = np.asarray(blk.apply({"params": p}, jnp.asarray(x, jnp.bfloat16)), np.float32)
    names = ("dwconv_w", "dwconv_b", "norm_scale", "norm_bias", "pw1_w", "pw1_b", "pw2_w",
             "pw2_b", "gamma")
    out = convnext_block_reference(t(x).to(BF16), *(t(np.asarray(p[n])) for n in names))
    assert out.dtype == BF16
    assert gap("convnext_block_vs_xla", out, ref) < 0.03


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5), (BF16, 0.03)], ids=["f32", "bf16"])
def test_apply_fused_matches_the_generator(dtype, tol):
    """JAX tests/test_pallas_convnext.py:105-111: `apply_fused` against the
    generator's forward, fp32 and bf16."""
    mel = t(np.random.default_rng(6).normal(-1, 1, (2, 32, 80)).astype(np.float32))
    gen = VocosGenerator(dim=128, intermediate_dim=256, num_layers=2, dtype=dtype).eval()
    with torch.no_grad():
        ref, out = gen(mel).numpy(), apply_fused(gen, mel).numpy()
    assert np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-3) < tol


def _acoustic_batch():
    rng = np.random.default_rng(0)
    b, c = 4, 4
    return {"audiotypes": t((np.arange(b) % 2).astype(np.int32)),
            "texts": t(rng.integers(1, 16, (b, c)).astype(np.int32)),
            "src_lens": t(np.full((b,), c, np.int32)),
            "image_cells": t(rng.uniform(0, 1, (b, c, 24, 30)).astype(np.float32)),
            "energies": t(rng.standard_normal((b, c)).astype(np.float32)),
            "durations": t(np.full((b, c), 8, np.int32)),
            "mels": t(rng.standard_normal((b, 32, 16)).astype(np.float32))}


def test_bf16_acoustic_overfit_and_closeness():
    """JAX tests/test_training.py:126: 30 bf16 steps on one batch bring the
    total loss below 0.8 of the first; parameters stay fp32; the bf16
    forward's postnet mel within 0.1 mean relative error of the fp32
    forward's on the same parameters."""
    from visual_onoma_to_wave_tpu_torch.training.schedule import NoamAdam
    from visual_onoma_to_wave_tpu_torch.training.train_state import TrainState, train_step

    kw = dict(n_vocab=16, n_audiotype=2, hidden=32, encoder_layers=1, decoder_layers=1,
              n_head=2, d_inner=64, ffn_kernel=(3, 1), max_seq_len=64, max_mel_len=64,
              n_mels=16, vfe_layers=1, energy_stats=(-2.0, 2.0, 0.0, 1.0), cell_hw=(24, 30))
    torch.manual_seed(0)
    model = VTTS(**kw, dtype=BF16)
    state = TrainState(model, NoamAdam(model.parameters(), init_lr=2e-3, warmup_steps=5),
                       torch.Generator().manual_seed(1))
    batch = _acoustic_batch()
    first = None
    for _ in range(30):
        losses = train_step(state, batch)
        first = first if first is not None else float(losses["total_loss"])
        assert all(p.dtype == torch.float32 for p in model.parameters())
        assert all(p.grad is None or p.grad.dtype == torch.float32 for p in model.parameters())
    last = float(losses["total_loss"])
    assert np.isfinite(last) and last < 0.8 * first, (first, last)

    model32 = VTTS(**kw)
    model32.load_state_dict(model.state_dict())
    inputs = {k: batch[k] for k in ("audiotypes", "texts", "src_lens", "image_cells")}
    with torch.no_grad():
        outs = [m.eval()(**inputs, energy_targets=batch["energies"],
                         duration_targets=batch["durations"])["postnet_mel"]
                for m in (model, model32)]
    m16, m32 = (o.numpy() for o in outs)
    assert outs[0].dtype == torch.float32
    assert np.abs(m16 - m32).mean() / (np.abs(m32).mean() + 1e-6) < 0.1


def _gan_trainer(cfg, **kw):
    from visual_onoma_to_wave_tpu_torch.training.vocoder_trainer import VocoderTrainer

    return VocoderTrainer([_clip()], cfg, device="cpu", **kw)


def _clip():
    rng = np.random.default_rng(5)
    time = np.arange(6000) / 22050.0
    return (0.5 * np.sin(2 * np.pi * 220 * time) + rng.normal(0, 0.05, 6000)).astype(np.float32)


def _tiny_cfg(**kw):
    from visual_onoma_to_wave_tpu_torch.training.vocoder_trainer import VocoderTrainConfig

    return VocoderTrainConfig(**{"segment_size": 2048, "batch_size": 2, "log_every": 1000,
                                 "save_every": 10 ** 9, **kw})


def test_bf16_mixed_precision_gan_step_trains():
    """JAX tests/test_vocoder_training.py:522: a bf16 step runs finite,
    every parameter stays fp32, the generator moves, and 30 more steps bring
    the mel L1 below the first step's."""
    cfg = _tiny_cfg(learning_rate=5e-4, compute_dtype="bfloat16")
    gen = HiFiGANGenerator(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                           resblock_dilations=((1, 2),), dtype=BF16)
    trainer = _gan_trainer(
        cfg, gen=gen, mpd=tdisc.MultiPeriodDiscriminator((2, 3), (4, 8), dtype=BF16),
        msd=tdisc.MultiScaleDiscriminator(2, 4, dtype=BF16))
    st = trainer.state
    before = [p.detach().clone() for p in st.gen.parameters()]
    m1 = trainer.train_step(torch.from_numpy(trainer.sampler.next_batch()))
    for k in ("d_total", "g_adv", "g_fm", "mel_l1", "g_total"):
        assert m1[k].dtype == torch.float32 and np.isfinite(float(m1[k])), k
    for m in (st.gen, st.mpd, st.msd):
        assert all(p.dtype == torch.float32 for p in m.parameters())
    assert any((a - b).abs().max() > 0 for a, b in zip(before, st.gen.parameters()))
    first = float(m1["mel_l1"])
    trainer.train(steps=30)
    m = trainer.train_step(torch.from_numpy(trainer.sampler.next_batch()))
    assert float(m["mel_l1"]) < first


def test_default_trainer_modules_pick_up_compute_dtype():
    """JAX tests/test_vocoder_training.py:562."""
    trainer = _gan_trainer(_tiny_cfg(compute_dtype="bfloat16"), gen=None)
    assert trainer.gen.dtype == trainer.mpd.dtype == trainer.msd.dtype == BF16
    assert all(p.dtype == torch.float32 for p in trainer.gen.parameters())
    fp32 = _gan_trainer(_tiny_cfg(), gen=None)
    assert fp32.gen.dtype == fp32.mpd.dtype == fp32.msd.dtype == torch.float32


def test_get_vocoder_dtype_and_melgan_ignoring_it():
    """`get_vocoder(model, dtype=)` as the JAX package's: every family but
    MelGAN takes it; strings as `train.compute_dtype` spells them."""
    for name in ("HiFi-GAN", "HiFi-GAN_v3", "iSTFTNet", "iSTFTNet-mel", "Vocos", "BigVGAN"):
        assert get_vocoder(name, dtype="bfloat16").dtype == BF16, name
        assert get_vocoder(name).dtype == torch.float32, name
    assert not hasattr(get_vocoder("MelGAN", dtype=BF16), "dtype")
    assert compute_dtype("bf16") == compute_dtype(BF16) == BF16
    assert compute_dtype("float32") == compute_dtype(None) == compute_dtype("fp16") == torch.float32


def test_vtts_from_config_reads_compute_dtype():
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples"))
    import export_demo_for_torch as demo

    cfg = demo.port_demo_config()
    assert VTTS.from_config(cfg).dtype == torch.float32
    for name in ("bfloat16", "bf16"):
        bf16 = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=name))
        model = VTTS.from_config(bf16)
        assert model.dtype == BF16 and model.decoder.layer_stack[0].slf_attn.dtype == BF16
        assert model.postnet.dtype == BF16
        assert all(p.dtype == torch.float32 for p in model.parameters())


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------

def test_mrf_pack_cache_is_keyed_by_dtype():
    """The per-stage pack cache never serves one operand type's packing to
    another: on the card a bf16 call gets bf16 planes, an fp32 call fp32."""
    gen = HiFiGANGenerator(**HIFI_KW)
    stages = gen._mrf
    blocks = gen.resblocks[:3]
    fp32 = stages.packed(0, blocks, torch.float32)
    bf16 = stages.packed(0, blocks, BF16)
    assert all(p.dtype == BF16 for p in bf16[2]) and all(p.dtype == torch.float32
                                                         for p in fp32[2])
    assert stages.packed(0, blocks, BF16) is bf16
    assert stages.packed(0, blocks, torch.float32) is not bf16


def _old_forwards():
    """The forwards of the fp32 modules as they were before the compute
    dtype existed: each a plain composition of the module's parts."""
    def mha(m, x, mask):
        ctx = tl.attention_core(m.w_qs(x), m.w_ks(x), m.w_vs(x), mask, m.n_head)
        return m.layer_norm(m.dropout(m.fc(ctx)) + x)

    def ffn(m, x):
        h = m.w_2(torch.relu(m.w_1(x.transpose(1, 2)))).transpose(1, 2)
        return m.layer_norm(m.dropout(h) + x)

    def postnet(m, x):
        h = x.transpose(1, 2)
        for i, (conv, bn) in enumerate(m.convolutions):
            h = bn(conv.conv(h))
            h = torch.tanh(h) if i < len(m.convolutions) - 1 else h
        return h.transpose(1, 2)

    def hifigan(g, mel):
        x = g.conv_pre(mel.transpose(1, 2))
        for i, up in enumerate(g.ups):
            x = up(F.leaky_relu(x, 0.1))
            blocks = g.resblocks[i * g.num_kernels:(i + 1) * g.num_kernels]
            x = g._mrf(i, blocks, x)
        return torch.tanh(g.conv_post(F.leaky_relu(x, 0.01)))[:, 0, :]

    def wnconv(m, x):
        conv = F.conv1d if m.v.ndim == 3 else F.conv2d
        return conv(x, m.weight(), m.b, stride=m.stride, padding=m.padding, groups=m.groups)

    return mha, ffn, postnet, hifigan, wnconv


def test_fp32_modules_compute_what_they_computed_before():
    """Bit for bit: the fp32 path of every module this change touched is
    the forward it had before (`_old_forwards`), and `at_dtype` in fp32 is
    the module's own call."""
    mha, ffn, postnet, hifigan, wnconv = _old_forwards()
    rng = np.random.default_rng(9)
    torch.manual_seed(0)
    x = t(rng.normal(size=(2, 11, 32)).astype(np.float32))
    mask = t(pad_mask((11, 6), 11))
    block = tl.FFTBlock(32, 2, 16, 16, 48, (9, 1)).eval()
    with torch.no_grad():
        assert torch.equal(block.slf_attn(x, mask), mha(block.slf_attn, x, mask))
        assert torch.equal(block.pos_ffn(x), ffn(block.pos_ffn, x))
        pn = tl.PostNet(8, 16).eval()
        xm = t(rng.normal(size=(2, 13, 8)).astype(np.float32))
        assert torch.equal(pn(xm), postnet(pn, xm))
        gen = HiFiGANGenerator(**HIFI_KW).eval()
        mel = t(rng.normal(size=(2, 9, 80)).astype(np.float32))
        assert torch.equal(gen(mel), hifigan(gen, mel))
        lin = torch.nn.Linear(32, 8)
        assert torch.equal(at_dtype(lin, x, torch.float32), lin(x))
        for conv in (tdisc.WNConv(1, 4, (5,), (3,), (2,)), tdisc.WNConv(1, 4, (5, 1), (3, 1),
                                                                         (2, 0))):
            inp = torch.randn(2, 1, 64) if conv.v.ndim == 3 else torch.randn(2, 1, 21, 3)
            assert torch.equal(conv(inp), wnconv(conv, inp))
    # the MRF plain version in fp32: the 18-conv chain with each bias inside its conv
    stage = torch.nn.ModuleList(ResBlock1(16, k, (1, 3, 5)) for k in (3, 7, 11))
    xs = torch.randn(1, 16, 40)
    with torch.no_grad():
        mats, biases = MRFStages.pack(stage, torch.float32, "cpu")[:2]
        got = mrf_stage_fused(xs, *mats, biases)
        acc = None
        for block in stage:
            y = xs
            for c1, c2 in zip(block.convs1, block.convs2):
                y = y + c2(F.leaky_relu(c1(F.leaky_relu(y, 0.1)), 0.1))
            acc = y if acc is None else acc + y
    assert torch.equal(got, acc / 3)


def test_bf16_export_runs_on_the_cpu(tmp_path):
    """A bf16 synthesizer of the demo checkpoint (`train.compute_dtype:
    bfloat16`, the vocoder's `dtype` in `model.vocoder_kwargs`) exports for
    the CPU and serves what the live bf16 path serves."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples"))
    import export_demo_for_torch as demo

    from visual_onoma_to_wave_tpu_torch.export import ExportedSynthesizer, export_synthesizer
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    cfg = demo.port_demo_config()
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"),
                      model=dataclasses.replace(cfg.model, vocoder_kwargs={
                          **cfg.model.vocoder_kwargs, "dtype": "bfloat16"}))
    live = Synthesizer.from_checkpoint(cfg, str(demo.OUT / "acoustic.npz"),
                                       str(demo.OUT / "vocoder.npz"), device="cpu")
    assert live.model.dtype == live.vocoder.dtype == BF16
    manifest = export_synthesizer(live, tmp_path, max_batch=2, text_lens=(4,), devices=("cpu",))
    assert manifest["acoustic_dtype"] == manifest["vocoder_dtype"] == "bfloat16"
    exported = ExportedSynthesizer.load(tmp_path, device="cpu")
    texts, types = ["パンパン", "ドン"], [0, 1]
    want = live.synthesize_batch(texts, types)
    got = exported.synthesize_batch(texts, types)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.durations, b.durations)
        assert a.mel_len == b.mel_len and a.wav.dtype == np.float32
        np.testing.assert_allclose(a.mel, b.mel, rtol=0, atol=1e-4)
        np.testing.assert_allclose(a.wav, b.wav, rtol=0, atol=1e-5)


def test_measured_gaps():
    """Prints the gaps the parity tests above recorded (with `-s`)."""
    for name, value in sorted(GAPS.items()):
        print(f"bf16 gap {name}: {value:.3e}")
