"""The port's HiFi-GAN discriminators and GAN losses against the JAX package,
on the CPU.

Parameters and inputs are made with numpy from a seed (or drawn by the JAX
module's own init); the JAX modules take them as they are and the port's
through `bridge.{mpd,msd,mrd}_state_dict`. Narrow widths: MPD channels
(4, 8, 16, 32), MSD channels 4, MRD channels 4, 2048-sample segments.
Tolerances, float32 on both sides, stated before the runs:

* logits and feature maps: 1e-6 absolute plus 1e-5 of the largest value
  (a few float32 roundings of conv sums; the MRD's magnitudes, O(10), enter
  its first conv);
* the three losses: 1e-6 relative;
* the reference's own properties (symmetry, the solo oracle, loss values
  at perfect and worst discrimination) exactly, or at 1e-6 as the JAX test
  states them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu.models import hifigan_disc as jdisc
from visual_onoma_to_wave_tpu_torch.bridge import (
    mpd_state_dict,
    mrd_state_dict,
    msd_state_dict,
)
from visual_onoma_to_wave_tpu_torch.models import hifigan_disc as tdisc

torch.set_num_threads(1)

MPD = dict(periods=(2, 3, 5, 7, 11), channels=(4, 8, 16, 32))
MSD = dict(n_scales=3, channels=4)
MRD = dict(channels=4)
# the reference test's sizes (tests/test_vocoder_training.py)
TINY_MPD = dict(periods=(2, 3), channels=(4, 8))
TINY_MSD = dict(n_scales=2, channels=4)

KINDS = {
    "mpd": (jdisc.MultiPeriodDiscriminator, tdisc.MultiPeriodDiscriminator, MPD, mpd_state_dict),
    "msd": (jdisc.MultiScaleDiscriminator, tdisc.MultiScaleDiscriminator, MSD, msd_state_dict),
    "mrd": (jdisc.MultiResolutionDiscriminator, tdisc.MultiResolutionDiscriminator, MRD,
            mrd_state_dict),
}


def audio_pair(seed: int, t: int = 2048):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.1, (2, t)).astype(np.float32),
            rng.normal(0, 0.1, (2, t)).astype(np.float32))


def both(kind: str, y: np.ndarray, y_hat: np.ndarray, seed: int = 0):
    """(JAX module, its variables, port module with the same weights)."""
    jcls, tcls, kw, bridge = KINDS[kind]
    jm = jcls(**kw)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.asarray(y), jnp.asarray(y_hat))
    tm = tcls(**kw)
    tm.load_state_dict(bridge(jax.tree.map(np.asarray, variables)))    # strict
    return jm, variables, tm


def channels_last(fmap: torch.Tensor) -> np.ndarray:
    """The port's (B, C, ...) map as the reference's (B, ..., C)."""
    return np.moveaxis(fmap.detach().numpy(), 1, -1)


def close(got: np.ndarray, want, what: str) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 + 1e-5 * float(np.abs(want).max()), err_msg=what)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_logits_and_feature_maps_match_jax(kind):
    y, y_hat = audio_pair(3)
    jm, variables, tm = both(kind, y, y_hat)
    rs, gs, fr, fg = jax.jit(jm.apply)(variables, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        trs, tgs, tfr, tfg = tm(torch.from_numpy(y), torch.from_numpy(y_hat))
    assert len(trs) == len(rs) and len(tfr) == len(fr)
    for i, (a, b) in enumerate(zip(trs + tgs, rs + gs)):
        close(a.numpy(), b, f"{kind} logits {i}")
    for i, (ma, mb) in enumerate(zip(tfr + tfg, fr + fg)):
        assert len(ma) == len(mb)
        for j, (a, b) in enumerate(zip(ma, mb)):
            close(channels_last(a), b, f"{kind} sub {i} map {j}")


def test_parameter_names_are_the_references():
    for kind, subs in (("mpd", {"p2", "p3", "p5", "p7", "p11"}), ("msd", {"s0", "s1", "s2"}),
                       ("mrd", {"r1024", "r2048", "r512"})):
        _, tcls, kw, _ = KINDS[kind]
        names = {n for n, _ in tcls(**kw).named_parameters()}
        assert {n.split(".")[0] for n in names} == subs
        assert {n.rsplit(".", 1)[1] for n in names} == {"v", "g", "b"}


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    real = [rng.normal(0.5, 1, (2, n)).astype(np.float32) for n in (7, 13)]
    gen = [rng.normal(0.2, 1, (2, n)).astype(np.float32) for n in (7, 13)]
    fr = [[rng.normal(size=(2, 3, 5)).astype(np.float32) for _ in range(3)] for _ in range(2)]
    fg = [[rng.normal(size=(2, 3, 5)).astype(np.float32) for _ in range(3)] for _ in range(2)]
    tt = lambda xs: [torch.from_numpy(x) for x in xs]   # noqa: E731
    pairs = [
        (tdisc.discriminator_loss(tt(real), tt(gen)), jdisc.discriminator_loss(real, gen)),
        (tdisc.generator_adversarial_loss(tt(gen)), jdisc.generator_adversarial_loss(gen)),
        (tdisc.feature_matching_loss([tt(m) for m in fr], [tt(m) for m in fg]),
         jdisc.feature_matching_loss(fr, fg)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_loss_properties():
    one, zero = [torch.ones(2, 5)], [torch.zeros(2, 5)]
    assert float(tdisc.discriminator_loss(one, zero)) == 0.0
    assert float(tdisc.generator_adversarial_loss(one)) == 0.0
    assert float(tdisc.discriminator_loss(zero, one)) == pytest.approx(2.0)
    fm = tdisc.feature_matching_loss([[torch.ones(2, 3)]], [[torch.zeros(2, 3)]])
    assert float(fm) == pytest.approx(2.0)


def test_mpd_shapes_and_period_view():
    mpd = tdisc.MultiPeriodDiscriminator(**TINY_MPD)
    y = torch.from_numpy(np.random.default_rng(0).normal(0, 0.1, (2, 2048)).astype(np.float32))
    with torch.no_grad():
        rs, gs, fr, fg = mpd(y, y + 0.1)
        assert len(rs) == len(gs) == len(fr) == len(fg) == 2
        for p, lr, mr in zip(TINY_MPD["periods"], rs, fr):
            assert lr.ndim == 2 and lr.shape[0] == 2
            assert len(mr) == len(TINY_MPD["channels"]) + 2
            # the period view: the last axis of every map is the period
            assert all(m.shape[-1] == p for m in mr)
        rs2, gs2, _, _ = mpd(y, y)
    for a, b in zip(rs2, gs2):
        assert torch.equal(a, b)


def test_msd_shapes_and_pooling():
    msd = tdisc.MultiScaleDiscriminator(**TINY_MSD)
    y = np.random.default_rng(1).normal(0, 0.1, (2, 2049)).astype(np.float32)
    with torch.no_grad():
        rs, _, fr, _ = msd(torch.from_numpy(y), torch.from_numpy(y))
    assert len(rs) == TINY_MSD["n_scales"]
    assert all(len(m) == 8 for m in fr)          # 7 conv layers + logits
    pooled = tdisc.avg_pool1d(torch.from_numpy(y))
    assert pooled.shape == (2, (2049 + 4 - 4) // 2 + 1)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jdisc._avg_pool1d(jnp.asarray(y))),
                               rtol=0, atol=1e-7)


def test_discriminator_symmetry_and_solo_oracle():
    """Scoring (y, y_hat) and the swapped (y_hat, y) cross over exactly, and
    the pair's real half equals one sub-discriminator driven alone."""
    y, yh = (torch.from_numpy(a) for a in audio_pair(7))
    torch.manual_seed(0)
    for mod in (tdisc.MultiPeriodDiscriminator(**TINY_MPD),
                tdisc.MultiScaleDiscriminator(**TINY_MSD),
                tdisc.MultiResolutionDiscriminator(channels=4)):
        with torch.no_grad():
            rs, gs, fr, fg = mod(y, yh)
            rs2, gs2, fr2, fg2 = mod(yh, y)
        for a, b in zip(rs + gs, gs2 + rs2):
            assert torch.equal(a, b)
        for ma, mb in zip(fr, fg2):
            for a, b in zip(ma, mb):
                assert torch.equal(a, b)
    mpd = tdisc.MultiPeriodDiscriminator(**TINY_MPD)
    msd = tdisc.MultiScaleDiscriminator(**TINY_MSD)
    with torch.no_grad():
        solo, _ = mpd.p2(y)
        torch.testing.assert_close(mpd(y, yh)[0][0], solo, rtol=0, atol=1e-6)
        solo, _ = msd.s0(y)
        torch.testing.assert_close(msd(y, yh)[0][0], solo, rtol=0, atol=1e-6)


def test_weight_norm_formula_and_init():
    """w = g * v / sqrt(sum v^2 + 1e-12) per output filter; g starts at
    sqrt(1/3) and v inside torch's conv default bound 1/sqrt(fan_in)."""
    torch.manual_seed(0)
    conv = tdisc.WNConv(6, 8, (41,), (2,), (20,), groups=2)
    fan_in = 3 * 41
    assert conv.v.shape == (8, 3, 41)
    assert float(conv.v.detach().abs().max()) <= 1.0 / np.sqrt(fan_in)
    assert torch.all(conv.g == np.float32(np.sqrt(1 / 3)))
    w = conv.weight()
    norms = w.reshape(8, -1).norm(dim=1)
    torch.testing.assert_close(norms, conv.g.detach(), rtol=1e-6, atol=0)
    v = conv.v.detach().double()
    want = conv.g.detach().double()[:, None, None] * v / torch.sqrt(
        (v * v).sum((1, 2), keepdim=True) + 1e-12)
    torch.testing.assert_close(w.detach().double(), want, rtol=1e-6, atol=0)


def test_mrd_magnitude_is_guarded_on_silence():
    """Zero-padded segments have exactly zero bins: the eps under the root
    keeps the discriminator's gradient finite there."""
    torch.manual_seed(0)
    mrd = tdisc.MultiResolutionDiscriminator(channels=4)
    x = torch.zeros(1, 2048, requires_grad=True)
    logits, _, _, _ = mrd(x, x.detach())
    sum(lg.sum() for lg in logits).backward()
    assert torch.isfinite(x.grad).all()


def test_grouped_counts_follow_gcd_at_narrow_widths():
    """At channels 4 the official group counts (4, 16) are cut to what the
    widths allow; at 128 they are the official ones."""
    narrow = [c.groups for c in tdisc.ScaleDiscriminator(4).convs]
    full = [c.groups for c in tdisc.ScaleDiscriminator(128).convs]
    assert narrow == [1, 4, 4, 8, 16, 16, 1, 1]
    assert full == [1, 4, 16, 16, 16, 16, 1, 1]
