"""GAN vocoder training of the PyTorch port against the JAX package, on the CPU.

The JAX `VocoderTrainer` draws its initial parameters; the port's trainer
takes the same ones through the bridge (`vocoder_state_dict`,
`mpd_state_dict`, `msd_state_dict`), and both samplers draw the same
batches from the same seed. Narrow widths: the reference test's generator
(upsample_initial_channel 16, one ResBlock1 branch), MPD channels (4, 8,
16, 32) at periods 2 and 3, MSD channels 4 at two scales, segments of 2048
samples, batch 2; torch on one thread. Tolerances, float32 on both sides, stated before the runs:

* one GAN step's seven losses: 1e-5 relative (mel L1 x 45 dominates the G
  loss; the two sides' STFTs and convs round differently);
* that step's gradients, leaf by leaf: 1e-4 of the leaf's largest value
  plus 1e-7 (a backward through four sub-discriminators and the
  generator);
* parameters after 3 steps: 2e-5 absolute plus 1e-4 relative, except where
  Adam's first updates are lr x the sign of a gradient of roundoff size:
  there a leaf may sit up to 3 x 2 x lr away (ROADMAP "Behaviours worth
  knowing"), and at most 1% of the elements do;
* the learning rate against `optax.exponential_decay`: 1e-6 relative;
  `clip_by_global_norm`: 1e-6 relative; samplers byte-equal; the watchdog's
  decisions identical.

The reference's behaviour tests (`tests/test_vocoder_training.py`) follow,
run on the port alone, except data-parallel (tests/test_torch_distributed.py)
and bf16 (tests/test_torch_bf16.py).
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from visual_onoma_to_wave_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
from visual_onoma_to_wave_tpu.models import hifigan_disc as jdisc
from visual_onoma_to_wave_tpu.training import vocoder_trainer as jvt
from visual_onoma_to_wave_tpu_torch.bridge import (
    flatten_tree,
    load_npz,
    mpd_state_dict,
    msd_state_dict,
    vocoder_state_dict,
    vocoder_tree,
)
from visual_onoma_to_wave_tpu_torch.models import get_vocoder, vocoder_infer
from visual_onoma_to_wave_tpu_torch.models.hifigan import HiFiGANGenerator
from visual_onoma_to_wave_tpu_torch.models.hifigan_disc import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
)
from visual_onoma_to_wave_tpu_torch.training import vocoder_trainer as tvt
from visual_onoma_to_wave_tpu_torch.training.vocoder_trainer import (
    OptaxAdamW,
    PairedSegmentSampler,
    SegmentSampler,
    VocoderTrainConfig,
    VocoderTrainer,
    family_recipe,
)

GEN = dict(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
           upsample_initial_channel=16, resblock_kernel_sizes=(3,), resblock_dilations=((1, 2),))
# the reference test's sizes, for the behaviour tests
TINY_MPD = dict(periods=(2, 3), channels=(4, 8))
TINY_MSD = dict(n_scales=2, channels=4)
LOSSES = ("d_total", "d_mpd", "d_msd", "g_adv", "g_fm", "mel_l1", "g_total")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_cfg(**kw) -> VocoderTrainConfig:
    kw.setdefault("segment_size", 2048)
    kw.setdefault("batch_size", 2)
    kw.setdefault("log_every", 1000)
    kw.setdefault("save_every", 10 ** 9)
    return VocoderTrainConfig(**kw)


def sine(n: int = 6000, noise: float = 0.0, seed: int = 0) -> np.ndarray:
    t = np.arange(n) / 22050.0
    x = 0.5 * np.sin(2 * np.pi * 220 * t)
    if noise:
        x = x + np.random.default_rng(seed).normal(0, noise, n)
    return x.astype(np.float32)


def port_trainer(clips, cfg=None, gen=None, **kw) -> VocoderTrainer:
    kw.setdefault("mpd", MultiPeriodDiscriminator(**TINY_MPD))
    kw.setdefault("msd", MultiScaleDiscriminator(**TINY_MSD))
    return VocoderTrainer(clips, cfg or tiny_cfg(), gen=gen or HiFiGANGenerator(**GEN),
                          device="cpu", **kw)


def params_of(module) -> dict[str, np.ndarray]:
    return {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

# the GAN step against JAX: MPD channels (4, 8, 16, 32) at two periods and
# MSD channels 4 at two scales (every period and scale is held to JAX in
# tests/test_torch_hifigan_disc.py); fewer sub-discriminators keep JAX's
# compiles short
STEP_MPD = dict(periods=(2, 3), channels=(4, 8, 16, 32))
STEP_MSD = dict(n_scales=2, channels=4)


def port_twin(clips, jcfg, state) -> VocoderTrainer:
    """The port's trainer at the JAX trainer's parameters `state` (host)."""
    pt = VocoderTrainer(clips, VocoderTrainConfig(**dataclasses.asdict(jcfg)),
                        gen=HiFiGANGenerator(**GEN), device="cpu",
                        mpd=MultiPeriodDiscriminator(**STEP_MPD),
                        msd=MultiScaleDiscriminator(**STEP_MSD))
    pt.gen.load_state_dict(vocoder_state_dict("hifigan", state.gen_params))
    pt.mpd.load_state_dict(mpd_state_dict(state.mpd_params))
    pt.msd.load_state_dict(msd_state_dict(state.msd_params))
    return pt


def jax_step_grads(jt, audio):
    """The D gradients at the initial state, and the G gradients against the
    D updated by them: the recompute formulation, which the reference's own
    test holds equal to its single-forward step."""
    cfg, st = jt.cfg, jt.state
    from visual_onoma_to_wave_tpu.ops.stft import hann_window, logmel_and_energy, melscale_fbanks
    window = jnp.asarray(hann_window(cfg.win_length))
    fb = jnp.asarray(melscale_fbanks(cfg.n_fft // 2 + 1, cfg.f_min, cfg.f_max, cfg.n_mels,
                                     cfg.sampling_rate))
    t_mel = cfg.segment_size // cfg.hop_length

    def mel_of(a):
        return logmel_and_energy(a, window, fb, cfg.n_fft, cfg.hop_length,
                                 cfg.win_length)[0][..., :t_mel]

    mel_target = mel_of(audio)
    y_sg = jax.lax.stop_gradient(jt.gen.apply(st.gen_params, mel_target.swapaxes(1, 2)))

    def d_loss(dp):
        pr, pg, _, _ = jt.mpd.apply({"params": dp[0]}, audio, y_sg)
        sr, sg, _, _ = jt.msd.apply({"params": dp[1]}, audio, y_sg)
        return jdisc.discriminator_loss(pr, pg) + jdisc.discriminator_loss(sr, sg)

    dparams = (st.mpd_params, st.msd_params)
    d_grads = jax.jit(jax.grad(d_loss))(dparams)
    d_up, _ = jt.disc_tx.update(d_grads, st.disc_opt, dparams)
    mp2, sp2 = optax.apply_updates(dparams, d_up)

    def g_loss(gp):
        yh = jt.gen.apply(gp, mel_target.swapaxes(1, 2))
        mel_l1 = jnp.mean(jnp.abs(mel_of(yh) - mel_target))
        pr, pg, fpr, fpg = jt.mpd.apply({"params": mp2}, audio, yh)
        sr, sg, fsr, fsg = jt.msd.apply({"params": sp2}, audio, yh)
        return (jdisc.generator_adversarial_loss(pg) + jdisc.generator_adversarial_loss(sg)
                + jdisc.feature_matching_loss(fpr, fpg) + jdisc.feature_matching_loss(fsr, fsg)
                + cfg.mel_loss_weight * mel_l1)

    g_grads = jax.jit(jax.grad(g_loss))(st.gen_params)
    return jax.device_get(d_grads), jax.device_get(g_grads)


def assert_leafwise(got: dict, want: dict, what: str, rel=1e-4, floor=1e-7) -> None:
    assert got.keys() == want.keys(), what
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(np.asarray(got[k]), w, rtol=0,
                                   atol=floor + rel * float(np.abs(w).max()), err_msg=f"{what} {k}")


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer's initial state, its first batch's gradients, its
    first step's losses and its state after 3 steps (all on the host)."""
    clip = np.random.default_rng(11).normal(0, 0.2, 9000).astype(np.float32)
    jcfg = jvt.VocoderTrainConfig(segment_size=2048, batch_size=2, log_every=1000,
                                  save_every=10 ** 9, learning_rate=5e-4)
    jt = jvt.VocoderTrainer([clip], jcfg, gen=JHiFiGAN(**GEN), use_mesh=False,
                            mpd=jdisc.MultiPeriodDiscriminator(**STEP_MPD),
                            msd=jdisc.MultiScaleDiscriminator(**STEP_MSD))
    init = jax.device_get(jt.state)
    batches = [jt.sampler.next_batch() for _ in range(3)]
    grads = jax_step_grads(jt, jnp.asarray(batches[0]))
    state, metrics = jt.state, []
    for b in batches:
        state, m = jt.train_step(state, jnp.asarray(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(clip=clip, jcfg=jcfg, init=init, batches=batches, grads=grads,
                metrics=metrics, final=jax.device_get(state))


def test_one_gan_step_matches_jax(jax_run):
    pt = port_twin([jax_run["clip"]], jax_run["jcfg"], jax_run["init"])
    batch = pt.sampler.next_batch()
    np.testing.assert_array_equal(batch, jax_run["batches"][0])
    pm = pt.train_step(torch.from_numpy(batch))
    for k in LOSSES:
        np.testing.assert_allclose(float(pm[k]), jax_run["metrics"][0][k], rtol=1e-5, err_msg=k)
    # the port's gradients stay on the parameters after the step: the
    # discriminators' from the D update, the generator's from the G update
    d_grads, g_grads = jax_run["grads"]
    grads = lambda m: {n: p.grad.numpy() for n, p in m.named_parameters()}  # noqa: E731
    assert_leafwise(grads(pt.gen), {k: v.numpy() for k, v in
                                    vocoder_state_dict("hifigan", g_grads).items()}, "G grad")
    assert_leafwise(grads(pt.mpd), {k: v.numpy() for k, v in mpd_state_dict(d_grads[0]).items()},
                    "MPD grad")
    assert_leafwise(grads(pt.msd), {k: v.numpy() for k, v in msd_state_dict(d_grads[1]).items()},
                    "MSD grad")


def test_params_after_three_steps_match_jax(jax_run):
    pt = port_twin([jax_run["clip"]], jax_run["jcfg"], jax_run["init"])
    for b in jax_run["batches"]:
        pt.train_step(torch.from_numpy(b))
    s = jax_run["final"]
    lr = jax_run["jcfg"].learning_rate
    for what, module, want in (("G", pt.gen, vocoder_state_dict("hifigan", s.gen_params)),
                               ("MPD", pt.mpd, mpd_state_dict(s.mpd_params)),
                               ("MSD", pt.msd, msd_state_dict(s.msd_params))):
        got = params_of(module)
        total = off = 0
        for k, w in want.items():
            w = w.numpy()
            diff = np.abs(got[k] - w)
            assert diff.max() <= 6 * lr, (what, k, diff.max())
            off += int(np.sum(diff > 2e-5 + 1e-4 * np.abs(w)))
            total += w.size
        assert off <= 0.01 * total, (what, off, total)


def test_learning_rate_over_2500_steps_matches_optax():
    sched = optax.exponential_decay(2e-4, transition_steps=1000, decay_rate=0.999,
                                    staircase=True)
    p = torch.nn.Parameter(torch.zeros(3))
    opt = OptaxAdamW([p], 2e-4, 0.8, 0.99, 1000, 0.999)
    counts = np.arange(2500)
    want = np.asarray(jax.vmap(sched)(jnp.asarray(counts)))
    got = np.array([opt.lr_at(int(c)) for c in counts])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the rate applied is the one of the count before the update
    for c in (0, 999, 1000, 2499):
        opt.count = c
        p.grad = torch.ones(3)
        opt.step()
        assert opt.adam.param_groups[0]["lr"] == opt.lr_at(c)
        assert opt.count == c + 1


@pytest.mark.parametrize("scale", [0.01, 10.0], ids=["below", "above"])
def test_clip_matches_optax_clip_by_global_norm(scale):
    rng = np.random.default_rng(3)
    grads = [rng.normal(0, scale, s).astype(np.float32) for s in ((7, 3), (11,), (2, 5, 4))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = OptaxAdamW.clip_(got, 1.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    if scale < 1:          # below the bound: untouched, bit for bit
        for a, g in zip(got, grads):
            np.testing.assert_array_equal(a.numpy(), g)


def test_samplers_are_byte_equal_to_jax():
    rng = np.random.default_rng(4)
    clips = [rng.normal(0, 0.3, n).astype(np.float32) for n in (5000, 100, 2048, 9000)]
    jcfg = jvt.VocoderTrainConfig(segment_size=2048, batch_size=3, seed=5)
    cfg = VocoderTrainConfig(segment_size=2048, batch_size=3, seed=5)
    js, ps = jvt.SegmentSampler(clips, jcfg), SegmentSampler(clips, cfg)
    pairs = [(rng.normal(0, 0.3, n * 256).astype(np.float32),
              rng.normal(-3, 1, (n + 2, 80)).astype(np.float32)) for n in (40, 5, 8)]
    jp, pp = jvt.PairedSegmentSampler(pairs, jcfg), PairedSegmentSampler(pairs, cfg)
    for _ in range(5):
        a, b = ps.next_batch(), js.next_batch()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        (a1, m1), (a2, m2) = pp.next_batch(), jp.next_batch()
        assert a1.tobytes() == a2.tobytes() and m1.shape == m2.shape
        assert np.ascontiguousarray(m1).tobytes() == np.ascontiguousarray(m2).tobytes()


class WatchdogProbe:
    """The watchdog's state alone (the reference test's `_WatchdogProbe`),
    driving either package's `_check_divergence`."""

    def __init__(self, cfg, method):
        self.cfg, self.method = cfg, method
        self.diverged_at = None
        self._best_mel_l1 = float("inf")
        self._bad_windows = 0
        self._windows_seen = 0
        self._last_mel = None
        self._frozen_windows = 0

    def feed(self, step, mel_l1, g=1.0, d=1.0):
        return self.method(self, step, {"mel_l1": mel_l1, "g_total": g, "d_total": d})


def watchdog_sequences():
    rng = np.random.default_rng(9)
    seqs = [
        [0.62, 0.44, 0.60, 0.43, 0.58, 0.52, 0.37, 0.40, 0.32, 0.31, 0.30, 0.39, 0.45],
        [0.62, 0.31, 0.25, 0.24, 0.18, 2.19, 2.43, 2.04, 2.5],
        [0.2, 1.5, 0.21, 1.5, 0.2, float("nan"), 0.3],
        [2.41, 2.16, 2.04, 2.21, 2.08, 2.19, 2.33, 2.2],
        [6.4, 2.8, 1.2, 0.8, 0.52, 0.61, 0.43, 0.50],
        [3.0, 2.8, 2.6, 2.7, 2.5, 2.6, 2.55, 2.4, 2.45, 2.3],
        [0.62, 0.31, 0.31, 0.31, 0.31, 0.2],
    ]
    for _ in range(12):      # noisy runs with spikes, repeats and rails
        x = list(np.round(np.abs(rng.normal(0.5, 0.3, 30)) + 0.05, 2))
        k = int(rng.integers(5, 25))
        if rng.uniform() < 0.5:
            x[k:] = list(np.round(rng.uniform(1.6, 2.6, 30 - k), 2))
        if rng.uniform() < 0.3:
            x[k:k + 5] = [x[k]] * 5
        seqs.append([float(v) for v in x])
    return seqs


@pytest.mark.parametrize("knobs", [dict(), dict(divergence_patience=3),
                                   dict(divergence_patience=3, divergence_warmup_windows=2),
                                   dict(frozen_patience=2, divergence_factor=2.0)],
                         ids=["defaults", "patience3", "warmup2", "frozen2-factor2"])
def test_watchdog_decides_as_jax(knobs):
    for seq in watchdog_sequences():
        j = WatchdogProbe(jvt.VocoderTrainConfig(**knobs), jvt.VocoderTrainer._check_divergence)
        p = WatchdogProbe(VocoderTrainConfig(**knobs), VocoderTrainer._check_divergence)
        for i, v in enumerate(seq):
            g = float("inf") if v == 2.5 else 1.0
            assert p.feed(100 * (i + 1), v, g=g) == j.feed(100 * (i + 1), v, g=g), (seq, i)
            assert (p.diverged_at, p._bad_windows, p._frozen_windows) == \
                (j.diverged_at, j._bad_windows, j._frozen_windows)


# ---------------------------------------------------------------------------
# generators: the plain chain in .train(), and the bridge's round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,kw", [
    ("HiFi-GAN", dict(upsample_initial_channel=16)),
    ("iSTFTNet-mel", dict(upsample_initial_channel=16)),
    ("Vocos", dict(dim=16, intermediate_dim=24, num_layers=2)),
])
def test_generator_in_train_mode_builds_an_autograd_graph(family, kw):
    """In .train() every MRF stage and ConvNeXt block takes its plain version
    with autograd (on the card too: the kernels have no backward), and the
    output equals .eval()'s on the CPU."""
    torch.manual_seed(0)
    gen = get_vocoder(family, **kw).train()
    mel = torch.randn(2, 12, 80) - 3.0
    wav = gen(mel)
    assert wav.requires_grad and wav.grad_fn is not None
    wav.square().mean().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in gen.parameters())
    with torch.no_grad():
        torch.testing.assert_close(gen.eval()(mel), wav.detach(), rtol=0, atol=1e-6)


FAMILIES = [("hifigan", dict(upsample_initial_channel=16)),
            ("hifigan-v2", dict(upsample_initial_channel=16)),
            ("hifigan-v3", dict(upsample_initial_channel=16)),
            ("istftnet", dict(upsample_initial_channel=16)),
            ("istftnet-mel", dict(upsample_initial_channel=16)),
            ("vocos", dict(dim=16, intermediate_dim=24, num_layers=2)),
            ("bigvgan", dict(upsample_initial_channel=16))]


@pytest.mark.parametrize("family,kw", FAMILIES, ids=[f for f, _ in FAMILIES])
def test_vocoder_tree_inverts_the_bridge(family, kw):
    """vocoder_tree(vocoder_state_dict(tree)) == tree, and JAX's generator on
    the round-tripped tree gives the port's waveform (1e-5 absolute)."""
    from visual_onoma_to_wave_tpu.models.vocoder import get_vocoder as jget_vocoder

    jgen = jget_vocoder(family, **kw)
    mel = np.random.default_rng(1).normal(-3, 1, (1, 9, 80)).astype(np.float32)
    rng = np.random.default_rng(2)
    shapes = jax.eval_shape(lambda: jgen.init(jax.random.PRNGKey(0), jnp.asarray(mel)))
    tree = jax.tree.map(lambda s: rng.normal(0, 0.05, s.shape).astype(np.float32), dict(shapes))
    gen = get_vocoder(family, **kw).eval()
    gen.load_state_dict(vocoder_state_dict(family, tree))
    back = vocoder_tree(family, gen.state_dict())
    a, b = flatten_tree(tree), flatten_tree(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    want = np.asarray(jax.jit(jgen.apply)(back, jnp.asarray(mel)))
    with torch.no_grad():
        got = gen(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_vocoder_tree_refuses_melgan_and_unknown_tensors():
    with pytest.raises(ValueError, match="MelGAN"):
        vocoder_tree("MelGAN", {})
    sd = HiFiGANGenerator(**GEN).state_dict()
    sd["extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="unknown"):
        vocoder_tree("hifigan", sd)


# ---------------------------------------------------------------------------
# the reference's behaviours, on the port
# ---------------------------------------------------------------------------

def test_sampler_shapes_and_padding():
    s = SegmentSampler([np.ones(5000, np.float32), np.full(100, 0.5, np.float32)], tiny_cfg())
    batch = s.next_batch()
    assert batch.shape == (2, 2048)
    for row in batch:
        assert set(np.unique(row)) <= {0.0, 0.5, 1.0}


def test_grad_clip_norm_is_wired_and_trains():
    clip = np.random.default_rng(3).normal(0, 0.2, 6000).astype(np.float32)
    t = port_trainer([clip], tiny_cfg(learning_rate=1e-4, grad_clip_norm=1e3))
    assert t.state.gen_opt.clip == t.state.disc_opt.clip == 1e3
    p0 = params_of(t.gen)
    m = t.train_step(torch.from_numpy(t.sampler.next_batch()))
    assert all(np.isfinite(float(m[k])) for k in ("d_total", "g_total", "mel_l1"))
    assert any(np.abs(p0[k] - v).max() > 0 for k, v in params_of(t.gen).items())


def test_gan_step_updates_everything_and_overfits():
    t = port_trainer([sine()], tiny_cfg(learning_rate=5e-4))
    p0, d0 = params_of(t.gen), params_of(t.mpd)
    m1 = t.train_step(torch.from_numpy(t.sampler.next_batch()))
    assert t.state.step == 1
    for k in LOSSES:
        assert np.isfinite(float(m1[k])), k
    assert any(np.abs(p0[k] - v).max() > 0 for k, v in params_of(t.gen).items())
    assert any(np.abs(d0[k] - v).max() > 0 for k, v in params_of(t.mpd).items())
    t.train(steps=30)
    m = t.train_step(torch.from_numpy(t.sampler.next_batch()))
    assert float(m["mel_l1"]) < float(m1["mel_l1"])
    with torch.no_grad():
        wavs, lens = vocoder_infer(t.gen.eval(), torch.zeros(1, 8, 80))
    assert wavs.shape == (1, 8 * 256) and int(lens[0]) == 8 * 256


def test_checkpoint_feeds_load_vocoder_and_inference(tmp_path):
    from visual_onoma_to_wave_tpu_torch.config import Config, ModelConfig
    from visual_onoma_to_wave_tpu_torch.synthesis import load_vocoder

    t = port_trainer([np.zeros(4000, np.float32)], ckpt_dir=tmp_path)
    t.save(7)
    d = tmp_path / "7"
    assert sorted(p.name for p in d.iterdir()) == [
        "full_state.npz", "generator.npz", "sampler_state.json"]
    cfg = Config(model=ModelConfig(vocoder_model="HiFi-GAN", vocoder_kwargs=GEN))
    gen = load_vocoder(cfg, str(d / "generator.npz"))
    for k, v in params_of(gen).items():
        np.testing.assert_array_equal(v, params_of(t.gen)[k])
    with torch.no_grad():
        wavs = vocoder_infer(gen.eval(), torch.zeros(1, 4, 80))[0]
    assert wavs.shape == (1, 4 * 256)
    with np.load(d / "full_state.npz") as f:
        tags = {k.split("/")[0] for k in f.files}
    assert tags == {"step", "gen", "mpd", "msd", "gen_opt", "disc_opt"}


def test_resume_restores_full_state(tmp_path):
    clip = np.random.default_rng(3).normal(0, 0.2, 8000).astype(np.float32)
    cfg = tiny_cfg(ema_decay=0.9)
    t1 = port_trainer([clip], cfg, ckpt_dir=tmp_path)
    t1.train(steps=3)
    t1.save(3)
    ref = t1.full_state_arrays()
    t2 = port_trainer([clip], cfg, ckpt_dir=tmp_path)
    assert t2.restore() == 3
    got = t2.full_state_arrays()
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(t2.sampler.next_batch(), t1.sampler.next_batch())
    # the resumed trainer's next step is the uninterrupted one's
    m1 = t1.train_step(torch.from_numpy(t1.sampler.next_batch()))
    m2 = t2.train_step(torch.from_numpy(t2.sampler.next_batch()))
    for k in LOSSES:
        assert float(m1[k]) == float(m2[k]), k
    t2.train(steps=6)
    assert t2.state.step == 6
    with pytest.raises(FileNotFoundError):
        port_trainer([clip], cfg, ckpt_dir=tmp_path / "empty").restore()


def test_finetune_on_paired_mels():
    rng = np.random.default_rng(4)
    cfg = tiny_cfg()
    hop, t_seg = cfg.hop_length, cfg.segment_size // cfg.hop_length
    audio = rng.normal(0, 0.3, 40 * hop).astype(np.float32)
    mel = rng.normal(-3, 1, (40, cfg.n_mels)).astype(np.float32)
    a, m = PairedSegmentSampler([(audio, mel)], cfg).next_batch()
    assert a.shape == (cfg.batch_size, cfg.segment_size)
    assert m.shape == (cfg.batch_size, cfg.n_mels, t_seg)
    src = {tuple(np.round(r, 5)) for r in mel}
    assert all(tuple(np.round(r, 5)) in src for r in m[0].T)
    t = port_trainer(None, cfg, pairs=[(audio, mel)])
    t.train(steps=2)
    assert t.state.step == 2
    # an explicit mel equal to the audio's own gives the implicit step
    t2, t3 = port_trainer([audio], cfg), port_trainer([audio], cfg)
    batch = torch.from_numpy(t2.sampler.next_batch())
    own = t2.mel_of(batch)
    ma, mb = t2.train_step(batch), t3.train_step(batch, own)
    np.testing.assert_allclose(float(ma["g_total"]), float(mb["g_total"]), rtol=1e-5)


@pytest.fixture(scope="module")
def acoustic_trainer(tmp_path_factory):
    """The port's acoustic Trainer over a small synthetic corpus
    preprocessed with saved audio (the fine-tuning data path)."""
    from visual_onoma_to_wave_tpu_torch.config import config_from_dict
    from visual_onoma_to_wave_tpu_torch.data.formatting import format_dataset
    from visual_onoma_to_wave_tpu_torch.data.labels import prepare_textgrids
    from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor
    from visual_onoma_to_wave_tpu_torch.data.synthetic_corpus import build_corpus, work_config
    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer

    work = tmp_path_factory.mktemp("tf_pairs")
    raw_root, ono_root = build_corpus(work, 12)
    d = work_config(work, ono_root, 2)
    d["model"] = {"transformer": {"encoder_layer": 1, "decoder_layer": 1, "encoder_hidden": 32,
                                  "decoder_hidden": 32, "conv_filter_size": 64,
                                  "conv_kernel_size": [3, 1]},
                  "visual_feature_extractor": {"layer_num": 1},
                  "variance_predictor": {"filter_size": 32},
                  "max_seq_len": 128, "postnet_channels": 32}
    d["train"]["optimizer"]["batch_size"] = 2
    cfg = config_from_dict(d)
    format_dataset(cfg, raw_root)
    prepare_textgrids(cfg.path.formatted, list(cfg.dataset.extract_labels))
    Preprocessor(cfg, num_workers=0, save_audio=True, device="cpu").build(verbose=False)
    return cfg, Trainer(cfg, device="cpu", loader_workers=0)


def test_teacher_forced_pairs_and_finetune(acoustic_trainer):
    cfg, trainer = acoustic_trainer
    pairs = tvt.teacher_forced_pairs(trainer)
    assert pairs
    hop = cfg.audio.stft.hop_length
    for a, m in pairs:
        assert len(a) == m.shape[0] * hop
        assert m.shape[1] == cfg.audio.mel.n_mel_channels
        assert np.isfinite(m).all() and np.isfinite(a).all()
    assert len(pairs) <= len(trainer.train_ds.rows)
    assert len(tvt.teacher_forced_pairs(trainer, limit=2)) == 2
    vt = port_trainer(None, tiny_cfg(), pairs=pairs)
    vt.train(steps=1)
    assert vt.state.step == 1


def test_rejects_hop_mismatch():
    gen = HiFiGANGenerator(upsample_rates=(8, 8, 2), upsample_kernel_sizes=(16, 16, 4),
                           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                           resblock_dilations=((1,),))
    with pytest.raises(ValueError, match="hop_length"):
        port_trainer([np.zeros(4000, np.float32)], gen=gen)


def test_not_yet_ported_options_name_their_roadmap_item():
    # bf16 compute is ported (tests/test_torch_bf16.py): it builds and names nothing
    assert port_trainer([np.zeros(4000, np.float32)],
                        tiny_cfg(compute_dtype="bfloat16")).cfg.compute_dtype == "bfloat16"
    with pytest.raises(NotImplementedError, match="A5"):
        port_trainer([np.zeros(4000, np.float32)], use_mesh=True)
    with pytest.raises(ValueError, match="ema_decay"):
        port_trainer([np.zeros(4000, np.float32)], tiny_cfg(ema_decay=1.0))


def test_single_forward_step_matches_recompute_formulation():
    """The step runs the generator once, its graph kept across the D
    update; the two-forward formulation (recompute y_hat inside the G loss)
    must agree on every updated parameter, as the reference's test holds."""
    cfg = tiny_cfg(learning_rate=5e-4)
    audio = torch.from_numpy(np.random.default_rng(7).normal(0, 0.3, (2, 2048))
                             .astype(np.float32))
    a = port_trainer([np.zeros(4096, np.float32)], cfg)
    b = port_trainer([np.zeros(4096, np.float32)], cfg)
    a.train_step(audio)

    st = b.state
    mel_target = b.mel_of(audio)
    y_sg = st.gen(mel_target.transpose(1, 2)).detach()
    pr, pg, _, _ = st.mpd(audio, y_sg)
    sr, sg, _, _ = st.msd(audio, y_sg)
    st.disc_opt.zero_grad()
    (discriminator_loss(pr, pg) + discriminator_loss(sr, sg)).backward()
    st.disc_opt.step()
    yh = st.gen(mel_target.transpose(1, 2))
    pr, pg, fpr, fpg = st.mpd(audio, yh)
    sr, sg, fsr, fsg = st.msd(audio, yh)
    g = (generator_adversarial_loss(pg) + generator_adversarial_loss(sg)
         + feature_matching_loss(fpr, fpg) + feature_matching_loss(fsr, fsg)
         + cfg.mel_loss_weight * torch.mean(torch.abs(b.mel_of(yh) - mel_target)))
    st.gen_opt.zero_grad()
    g.backward()       # the discriminators' grads from this are never applied
    st.gen_opt.step()
    for m_a, m_b in ((a.gen, b.gen), (a.mpd, b.mpd), (a.msd, b.msd)):
        pa, pb = params_of(m_a), params_of(m_b)
        for k in pa:
            np.testing.assert_allclose(pa[k], pb[k], rtol=2e-4, atol=2e-6, err_msg=k)


def test_ema_tracks_generator_and_checkpoints(tmp_path):
    cfg = tiny_cfg(learning_rate=5e-4, ema_decay=0.5)
    t = port_trainer([sine()], cfg, ckpt_dir=tmp_path)
    ema = [p.detach().clone() for p in t.gen.parameters()]
    for _ in range(3):
        t.train_step(torch.from_numpy(t.sampler.next_batch()))
        ema = [0.5 * e + 0.5 * p.detach() for e, p in zip(ema, t.gen.parameters())]
    for a, b in zip(ema, t.state.gen_ema):
        torch.testing.assert_close(b, a, rtol=2e-6, atol=1e-7)
    assert any((a - p).abs().max() > 1e-8 for a, p in zip(t.state.gen_ema, t.gen.parameters()))
    t.save(3)
    gen = HiFiGANGenerator(**GEN)
    gen.load_state_dict(vocoder_state_dict("hifigan", load_npz(tmp_path / "3" /
                                                               "generator_ema.npz")))
    for a, b in zip(gen.parameters(), t.state.gen_ema):
        assert torch.equal(a, b)
    t2 = port_trainer([sine()], cfg, ckpt_dir=tmp_path)
    assert t2.restore(3) == 3
    for a, b in zip(t2.state.gen_ema, t.state.gen_ema):
        assert torch.equal(a, b)


def test_ema_off_is_the_official_recipe(tmp_path):
    t = port_trainer([np.zeros(4096, np.float32)], ckpt_dir=tmp_path)
    assert t.state.gen_ema is None
    t.train_step(torch.from_numpy(t.sampler.next_batch()))
    assert t.state.gen_ema is None
    t.save(1)
    assert (tmp_path / "1" / "generator.npz").exists()
    assert not (tmp_path / "1" / "generator_ema.npz").exists()


def test_resblock2_family_trains():
    gen = HiFiGANGenerator(upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8),
                           upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                           resblock_dilations=((1, 2),), resblock_type="2")
    t = port_trainer([sine()], tiny_cfg(learning_rate=5e-4), gen=gen)
    p0 = params_of(t.gen)
    m = t.train_step(torch.from_numpy(t.sampler.next_batch()))
    assert all(np.isfinite(float(v)) for v in m.values())
    assert any(np.abs(p0[k] - v).max() > 0 for k, v in params_of(t.gen).items())


def probe(**knobs) -> WatchdogProbe:
    return WatchdogProbe(VocoderTrainConfig(**knobs), VocoderTrainer._check_divergence)


def test_divergence_watchdog_state_machine():
    w = probe()
    healthy = [0.62, 0.44, 0.60, 0.43, 0.58, 0.52, 0.37, 0.40, 0.32,
               0.31, 0.30, 0.39, 0.45, 0.41, 0.44, 0.62, 0.61, 0.60]
    assert not any(w.feed(100 * (i + 1), v) for i, v in enumerate(healthy))
    w = probe(divergence_patience=3)
    fired = [w.feed(100 * (i + 1), v)
             for i, v in enumerate([0.62, 0.31, 0.25, 0.24, 0.18, 2.19, 2.43, 2.04])]
    assert fired == [False] * 7 + [True] and w.diverged_at == 800
    assert w.feed(900, 2.5) is False
    w = probe(divergence_patience=2)
    assert not any(w.feed(s, v) for s, v in [(100, 0.2), (200, 1.5), (300, 0.21), (400, 1.5)])
    assert w._bad_windows == 1
    w = probe(divergence_patience=5)
    assert w.feed(100, 0.2) is False and w.feed(200, float("nan")) is True
    w = probe(divergence_patience=5)
    assert w.feed(100, 0.2) is False and w.feed(200, 0.2, g=float("inf")) is True


def test_divergence_watchdog_early_collapse_ceiling():
    w = probe(divergence_patience=3, divergence_warmup_windows=2)
    fired = [w.feed(100 * (i + 1), v)
             for i, v in enumerate([2.41, 2.16, 2.04, 2.21, 2.08, 2.19, 2.33])]
    assert fired == [False] * 5 + [True, False] and w.diverged_at == 600
    w = probe(divergence_patience=3, divergence_warmup_windows=2)
    assert not any(w.feed(100 * (i + 1), v)
                   for i, v in enumerate([6.4, 2.8, 1.2, 0.8, 0.52, 0.61, 0.43, 0.50]))
    w = probe(divergence_patience=3, divergence_warmup_windows=2)
    slow = [3.0, 2.8, 2.6, 2.7, 2.5, 2.6, 2.55, 2.4, 2.45, 2.3]
    assert not any(w.feed(100 * (i + 1), v) for i, v in enumerate(slow))
    assert w._bad_windows <= 2


def test_divergence_watchdog_frozen_metrics():
    w = probe(frozen_patience=3)
    assert not any(w.feed(100 * (i + 1), v) for i, v in enumerate([0.62, 0.44, 0.44, 0.31]))
    w = probe(frozen_patience=3)
    fired = [w.feed(100 * (i + 1), v) for i, v in enumerate([0.62, 0.31, 0.31, 0.31, 0.31])]
    assert fired == [False] * 4 + [True] and w.diverged_at == 500


def test_halted_trainer_does_not_resume(tmp_path, monkeypatch):
    t = port_trainer([sine(4096)], tiny_cfg(log_every=2), ckpt_dir=tmp_path)
    monkeypatch.setattr(t, "_check_divergence",
                        lambda step, m: t.__setattr__("diverged_at", step) or True)
    t.train(steps=10)
    assert t.state.step == 2
    t.train(steps=10)
    assert t.state.step == 2


def test_halt_writes_last_healthy_snapshot(tmp_path, monkeypatch):
    t = port_trainer([sine(4096)], tiny_cfg(log_every=2, healthy_snapshot_windows=1),
                     ckpt_dir=tmp_path)

    def fire_third(step, m):
        if step >= 6:
            t.diverged_at = step
            return True
        return False

    monkeypatch.setattr(t, "_check_divergence", fire_third)
    t.train(steps=10)
    assert t.diverged_at == 6 and t._healthy_snapshot[0] == 4
    d = tmp_path / "6"
    assert (d / "generator.npz").exists() and (d / "generator_last_healthy.npz").exists()
    snap = vocoder_state_dict("hifigan", load_npz(d / "generator_last_healthy.npz"))
    for k, v in snap.items():
        assert torch.equal(v, t._healthy_snapshot[1][k])
    assert any(not torch.equal(v, t.gen.state_dict()[k]) for k, v in snap.items())


def test_on_divergence_validation():
    with pytest.raises(ValueError, match="on_divergence"):
        port_trainer([sine(4096)], tiny_cfg(on_divergence="explode"))


def test_on_divergence_halt_stops_and_checkpoints(tmp_path, monkeypatch):
    t = port_trainer([sine(4096)], tiny_cfg(log_every=2), ckpt_dir=tmp_path)
    calls = []

    def fire(step, m):
        calls.append(step)
        t.diverged_at = step
        return True

    monkeypatch.setattr(t, "_check_divergence", fire)
    t.train(steps=10)
    assert calls == [2] and t.state.step == 2
    assert (tmp_path / "2" / "generator.npz").exists()
    assert json.loads((tmp_path / "2" / "HALTED.json").read_text())["diverged_at"] == 2
    fresh = port_trainer([sine(4096)], tiny_cfg(log_every=2), ckpt_dir=tmp_path)
    with pytest.raises(ValueError, match="not resumable"):
        fresh.restore()
    with pytest.raises(ValueError, match="not resumable"):
        fresh.restore(step=2)


def test_family_recipe_matches_jax():
    for fam in ("hifigan", "hifigan-v2", "hifigan-v3", "vocos", "melgan", "bigvgan",
                "bigvgan-large", "BigVGAN", "big_vgan", "istftnet", "istftnet-mel",
                "iSTFTNet-mel", "istftnet_mel"):
        assert family_recipe(fam) == jvt.family_recipe(fam), fam
    assert family_recipe("istftnet-mel") == {"learning_rate": 1e-4, "grad_clip_norm": 1e3,
                                             "disc": "msd"}


def test_longrun_tool_corpus_and_scores_match_the_reference_bench():
    """tools/vocoder_longrun_torch.py: the 24 clips byte-equal to the
    reference bench's (`bench_vocoder_quality._clip`), the held-out mels
    those of `jit_logmel` (compared before the log, as
    `test_torch_quality_gate.py` does: each bin within 5e-7 of itself plus
    1e-7 of the clip's largest, since near the ln(1e-5) floor the log
    magnifies float32 roundoff), and the copy-synthesis scores of one
    generator (random weights, bridged) within the reference scorer's
    rounding (4 decimals, MCD 2) plus 1e-4."""
    import sys

    from visual_onoma_to_wave_tpu.training.vocoder_trainer import VocoderTrainConfig as JCfg
    sys.path.insert(0, "benchmarks")
    sys.path.insert(0, "tools")
    import bench_vocoder_quality as ref
    import vocoder_longrun_torch as tool

    rng_a, rng_b = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(24):
        assert tool._clip(rng_a).tobytes() == ref._clip(rng_b).tobytes()
    _, jgt, jlogmel = ref.corpus_and_gt(JCfg())
    clips, gt, logmel = tool.corpus_and_gt("cpu")
    assert len(clips) == 20 and len(gt) == len(jgt) == 4
    for (a, m), (ja, jm) in zip(gt, jgt):
        assert a.tobytes() == ja.tobytes()
        lin, jlin = np.exp(m.astype(np.float64)), np.exp(np.asarray(jm, np.float64))
        assert np.all(np.abs(lin - jlin) <= 5e-7 * jlin + 1e-7 * jlin.max())
    jgen = JHiFiGAN(**GEN)
    rng = np.random.default_rng(6)
    shapes = jax.eval_shape(lambda: jgen.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80))))
    tree = jax.tree.map(lambda s: rng.normal(0, 0.05, s.shape).astype(np.float32), dict(shapes))
    want = ref.make_scorer(jgen, jgt, jlogmel)(tree)
    gen = HiFiGANGenerator(**GEN)
    gen.load_state_dict(vocoder_state_dict("hifigan", tree))
    got = tool.make_scorer(gen, gt, logmel, "cpu")()
    for k, v in want.items():
        assert abs(got[k] - v) <= (5e-3 if k == "mcd_db" else 5e-5) + 1e-4, (k, got[k], v)
