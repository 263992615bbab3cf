"""BigVGAN's anti-aliased snake-beta sites and the AMP stage of the MRF op
(`ops/amp.py`, `csrc/amp.cu`, `ops/mrf.py`'s "snakebeta_aa" kind).

On the CPU: a numpy walk of the kernel's tiles, windows and clamped indices
equals the modules' site (`SnakeAct`) at T below, at and across a tile; the
op's CPU kernel at each activation kind equals the branches' modules
averaged (fp32 within 1e-5; bf16 at least as close to the fp32 modules as
the bf16 modules are, since it rounds less often); the op raises on what it
does not take; BigVGAN's route plan counts its 109 (large) or 73 (base)
sites and the fused call counts them; `MRFStages.runs_op` alone sends the
stages, `act_post` and the plan, and an anti-aliased layout the op does
not take raises off the CPU. Marked `gpu` (no JAX in this file):
the kernel against its plain version at C 24-768, the AMP op against the
modules at each stage shape of the large preset, BigVGAN large through the
kernel, and HiFi-GAN V1's bf16 stage launches unchanged. On a machine with
an NVIDIA GPU:

    python3 -m pytest tests/test_torch_amp.py -q
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu_torch import tracing
from visual_onoma_to_wave_tpu_torch.models import get_vocoder
from visual_onoma_to_wave_tpu_torch.models.bigvgan import AMPBlock1, SnakeAct
from visual_onoma_to_wave_tpu_torch.models.hifigan import ResBlock1
from visual_onoma_to_wave_tpu_torch.ops import amp, mrf

KS, DS = (3, 7, 11), ((1, 3, 5),) * 3
# the large preset's stage shapes (C, frames of a 1000-frame mel)
LARGE_STAGES = [(768, 4000), (384, 16000), (192, 32000), (96, 64000), (48, 128000),
                (24, 256000)]


def rel_rms(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def randomised(module: torch.nn.Module, seed: int, std: float = 0.1) -> torch.nn.Module:
    """Weights N(0, std), biases N(0, std), log alpha / beta U(-0.5, 0.5)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "log_" in name:
                p.copy_(torch.rand(p.shape, generator=g) - 0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * std)
    return module


def as_fp32(blocks: torch.nn.ModuleList) -> torch.nn.ModuleList:
    """A copy of bf16 `AMPBlock1` / `ResBlock1` modules computing in fp32."""
    out = copy.deepcopy(blocks)
    for m in out.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float32
    return out


# ------------------------------------------------------------------- CPU
def kernel_walk(x: np.ndarray, la: np.ndarray, lb: np.ndarray, tile: int) -> np.ndarray:
    """csrc/amp.cu's walk in float64, index for index: per row and tile of
    `tile` samples the operand window (8 a side, clamped); the 2x pairs for
    s from t0 - 3 in groups of four, each group from its 10 operand samples
    where they lie inside [0, T) (else each pair from the clamped ones, at
    the clamped end sample outside [0, T)); the outputs in groups of four,
    each from the 2x window's entries 2 (s - t0) + 1 .. + 12."""
    up, down = amp.UP_FILTER.astype(np.float64), amp.DOWN_FILTER.astype(np.float64)
    B, C, T = x.shape
    groups = (tile + 6 + 3) // 4
    out = np.zeros((B, C, T))
    for b in range(B):
        for c in range(C):
            alpha, inv_b = np.exp(la[c]), 1.0 / (np.exp(lb[c]) + 1e-9)

            def snake(u):
                return u + np.sin(alpha * u) ** 2 * inv_b

            for t0 in range(0, T, tile):
                sp = x[b, c, np.clip(np.arange(t0 - 8, t0 + tile + 8), 0, T - 1)]

                def p(i):
                    return sp[min(max(i, 0), T - 1) - (t0 - 8)]

                sv = np.zeros((4 * groups, 2))
                for grp in range(groups):
                    r0 = 4 * grp
                    s0 = t0 - 3 + r0
                    if s0 - 3 >= 0 and s0 + 6 < T:
                        q = sp[r0 + 2:r0 + 12]
                    else:
                        q = np.array([p(s0 - 3 + i) for i in range(10)])
                    for m in range(4):
                        s = s0 + m
                        if 0 <= s < T:
                            ue = sum(up[2 * i + 1] * q[m + 5 - i] for i in range(6))
                            uo = sum(up[2 * i] * q[m + 6 - i] for i in range(6))
                        else:
                            sc = min(max(s, 0), T - 1)
                            ue = sum(up[2 * i + 1] * p(sc + 2 - i) for i in range(6))
                            uo = sum(up[2 * i] * p(sc + 3 - i) for i in range(6))
                        ve, vo = snake(ue), snake(uo)
                        sv[r0 + m] = (ve, ve) if s < 0 else (vo, vo) if s >= T else (ve, vo)
                for grp in range(tile // 4):
                    q0 = 4 * grp
                    if t0 + q0 >= T:
                        break
                    w = sv[q0:q0 + 10].reshape(-1)
                    for m in range(4):
                        if t0 + q0 + m < T:
                            out[b, c, t0 + q0 + m] = sum(down[j] * w[2 * m + j + 1]
                                                         for j in range(12))
    return out


@pytest.mark.parametrize("T", [1, 3, 8, 16, 37, 50])
def test_kernel_walk_equals_the_modules_site(T):
    """Tiles of 16 samples (the kernel's 2048 scaled down): one tile shorter
    than the halo, exactly one, and several with a ragged last one."""
    site = randomised(SnakeAct(5), seed=T)
    x = torch.randn(2, 5, T, generator=torch.Generator().manual_seed(T)) * 3.0
    with torch.no_grad():
        want = site(x).double().numpy()
    got = kernel_walk(x.double().numpy(), site.log_alpha.detach().double().numpy(),
                      site.log_beta.detach().double().numpy(), tile=16)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("activation", ["snakebeta", "snake"])
def test_reference_site_equals_the_modules(activation):
    site = randomised(SnakeAct(7, activation), seed=3)
    x = torch.randn(3, 7, 50, generator=torch.Generator().manual_seed(1)) * 2.0
    lb = site.log_alpha if site.log_beta is None else site.log_beta
    with torch.no_grad():
        torch.testing.assert_close(amp.amp_act_reference(x, site.log_alpha, lb), site(x),
                                   rtol=0, atol=2e-6)
        assert torch.equal(amp.amp_act(x, site.log_alpha, lb),
                           amp.amp_act_reference(x, site.log_alpha, lb))


def stage_blocks(act: str, C: int, dtype: torch.dtype, seed: int) -> torch.nn.ModuleList:
    if act == "lrelu":
        blocks = torch.nn.ModuleList(ResBlock1(C, k, d, dtype) for k, d in zip(KS, DS))
    else:
        blocks = torch.nn.ModuleList(AMPBlock1(C, k, d, dtype=dtype) for k, d in zip(KS, DS))
    return randomised(blocks, seed)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("act", mrf.ACTS)
def test_op_cpu_kernel_equals_the_branches_averaged(act, dtype):
    """`mrf_stage_fused` on CPU tensors (its plain version) at each
    activation kind against the kind's modules (`ResBlock1`, `AMPBlock1`),
    averaged: fp32 within 1e-5 of their scale; bf16 no further from the
    fp32 modules than the bf16 modules are (the op rounds its streams and
    conv outputs once each, the modules after every op), and within 3%."""
    C = 24 if act == "snakebeta_aa" else 32
    blocks = stage_blocks(act, C, dtype, seed=11)
    x = torch.randn(2, C, 150, generator=torch.Generator().manual_seed(5))
    stages = mrf.MRFStages(KS, DS, act=act)
    mats, biases, _, la, lb = stages.packed(0, blocks, dtype, "cpu")
    with torch.no_grad():
        got = mrf.mrf_stage_fused(x.to(dtype), *mats, biases, KS, DS, act=act, log_alpha=la,
                                  log_beta=lb)
        truth = sum(b(x) for b in as_fp32(blocks)) / 3
        mods = sum(b(x.to(dtype)) for b in blocks) / 3
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, truth, rtol=0, atol=1e-5 * float(truth.abs().max()))
    else:
        assert rel_rms(got, truth) <= max(rel_rms(mods, truth), 1e-3) and \
            rel_rms(got, truth) < 0.03, (rel_rms(got, truth), rel_rms(mods, truth))


def test_amp_stage_on_the_cpu_runs_the_modules():
    """`MRFStages` of the AMP kind runs a CPU stage as its modules (JAX's
    BigVGAN arithmetic), whatever the dtype."""
    blocks = stage_blocks("snakebeta_aa", 8, torch.float32, seed=2)
    x = torch.randn(1, 8, 40, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = mrf.MRFStages(KS, DS, act="snakebeta_aa")(0, blocks, x)
        assert torch.equal(got, sum(b(x) for b in blocks) / 3)


def test_op_raises_on_what_it_does_not_take():
    blocks = stage_blocks("snakebeta_aa", 8, torch.float32, seed=1)
    mats, biases, _, la, lb = mrf.MRFStages(KS, DS, act="snakebeta_aa").packed(
        0, blocks, torch.float32, "cpu")
    x = torch.randn(1, 8, 20)
    with torch.no_grad():
        with pytest.raises(ValueError, match="activation"):
            mrf.mrf_stage_fused(x, *mats, biases, act="gelu")
        with pytest.raises(ValueError, match="log_alpha"):
            mrf.mrf_stage_fused(x, *mats, biases, act="snakebeta_aa")
        with pytest.raises(ValueError, match="activation"):
            mrf.MRFStages(KS, DS, act="tanh")
        meta = torch.device("meta")
        with pytest.raises(ValueError, match=r"\(18, 8\)"):     # checked before the device
            mrf._checked(x.to(meta), [m.to(meta) for m in mats], biases.to(meta), KS, DS,
                         torch.float32, None, "snakebeta_aa", la[:3].to(meta), lb.to(meta))
        with pytest.raises(ValueError, match="pack_amp_conv_weights"):
            mrf._checked(x.to(meta), [m.to(meta) for m in mats], biases.to(meta), KS, DS,
                         torch.float32, [m.to(meta) for m in mats], "snakebeta_aa",
                         la.to(meta), lb.to(meta))
        with pytest.raises(ValueError, match="C in"):          # the leaky kind's widths
            mrf._checked(torch.empty(1, 24, 20, device=meta), [], biases, KS, DS,
                         torch.float32)
    assert mrf.mrf_route(24, torch.bfloat16, act="snakebeta_aa") == "amp"


@pytest.mark.parametrize("C,T,k,d", [(128, 40, 11, 3), (128, 41, 11, 5), (256, 7, 7, 5),
                                     (128, 3, 11, 5), (64, 30, 11, 5), (128, 30, 3, 3)])
def test_amp_conv_folds_far_dilations(C, T, k, d):
    """A far-reaching dilated conv at a wide C as the conv2d over the d
    phases of T (padded where T is no multiple of d) equals the dilated
    conv1d; nearer ones and narrow widths are the conv1d itself."""
    g = torch.Generator().manual_seed(C + T + k + d)
    a, w = torch.randn(2, C, T, generator=g), torch.randn(C, C, k, generator=g) / 10
    got = mrf.amp_conv(a, w, d)
    assert got.is_contiguous()
    torch.testing.assert_close(got, torch.nn.functional.conv1d(a, w, padding=d * (k - 1) // 2,
                                                               dilation=d), rtol=0, atol=1e-5)


def test_amp_params_pack_in_the_convs_order():
    blocks = stage_blocks("snakebeta_aa", 6, torch.float32, seed=4)
    la, lb = mrf.pack_amp_params(blocks)
    assert la.shape == lb.shape == (18, 6) and la.dtype == torch.float32
    for b, block in enumerate(blocks):
        for i in range(3):
            assert torch.equal(la[6 * b + 2 * i], block.acts1[i].log_alpha)
            assert torch.equal(lb[6 * b + 2 * i + 1], block.acts2[i].log_beta)
    snake = torch.nn.ModuleList(AMPBlock1(6, k, d, "snake") for k, d in zip(KS, DS))
    la, lb = mrf.pack_amp_params(randomised(snake, 5))
    assert torch.equal(la, lb)
    mats, _ = mrf.pack_mrf_weights(blocks)
    convs = mrf.pack_amp_conv_weights(mats, torch.bfloat16)
    assert torch.equal(convs[1][3], blocks[1].convs2[1].weight.to(torch.bfloat16))


@pytest.mark.parametrize("preset,sites", [("BigVGAN-large", 109), ("BigVGAN", 73)])
def test_route_plan_counts_every_site(preset, sites):
    g = get_vocoder(preset, upsample_initial_channel=64)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert g.eval().amp_site_plan(cuda) == (sites, 0)
    assert g.amp_site_plan(cpu) == (0, sites)
    assert g.train().amp_site_plan(cuda) == (0, sites)
    plain = get_vocoder(preset, upsample_initial_channel=64, anti_aliased=False).eval()
    assert plain._mrf is None and plain.amp_site_plan(cuda) == (0, sites)


def test_every_anti_aliased_layout_goes_to_the_op():
    """An anti-aliased BigVGAN of a block layout the op does not take (two
    kernel sizes) keeps its AMP stages: its modules run on the CPU, and off
    the CPU (here the meta device, where the op's checks run first) the
    stage raises the op's layout error rather than running as modules."""
    kw = dict(upsample_initial_channel=32, resblock_kernel_sizes=(3, 7),
              resblock_dilations=((1, 3, 5), (1, 3, 5)))
    g = get_vocoder("BigVGAN", **kw).eval()
    assert g._mrf.act == "snakebeta_aa"
    assert g(torch.randn(1, 10, 80)).shape == (1, 10 * 256)
    with torch.device("meta"):
        g = get_vocoder("BigVGAN", **kw).eval()
    assert g.amp_site_plan(torch.device("meta")) == (49, 0)
    with pytest.raises(ValueError, match="three branches of three dilations"):
        g(torch.empty(1, 10, 80, device="meta"))


def test_one_rule_sends_stages_sites_and_counts():
    """`MRFStages.runs_op` alone decides: the stages, `act_post` and the
    route plan all follow it (a stand-in that runs every stage as modules
    off the CPU leaves every site plain; one that claims the op on the CPU
    counts every site fused)."""
    st = mrf.MRFStages(KS, DS, act="snakebeta_aa")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert st.runs_op(cuda, torch.bfloat16) and not st.runs_op(cuda, torch.bfloat16, False)
    assert not st.runs_op(cpu, torch.float32)
    lrelu = mrf.MRFStages(KS, DS)
    assert lrelu.runs_op(cpu, torch.float32) and not lrelu.runs_op(cpu, torch.bfloat16)
    assert not mrf.MRFStages(KS[:2], DS[:2]).runs_op(cpu, torch.float32)

    class Modules(mrf.MRFStages):
        def runs_op(self, device, dtype, fused=True):
            return False

    class Claims(mrf.MRFStages):
        def runs_op(self, device, dtype, fused=True):
            return fused

    g = get_vocoder("BigVGAN-large", upsample_initial_channel=64).eval()
    g._mrf = Modules(KS, DS, act="snakebeta_aa")
    assert g.amp_site_plan(cuda) == (0, 109)
    g._mrf = Claims(KS, DS, act="snakebeta_aa")
    assert g.amp_site_plan(cpu) == (109, 0) and g.train().amp_site_plan(cpu) == (0, 109)


class _Mels(torch.nn.Module):
    """A stand-in acoustic model: the batch's mels as its postnet output."""

    def forward(self, audiotypes, texts, src_lens, image_cells=None, e_control=1.0,
                d_control=1.0):
        return {"postnet_mel": texts}

    def acoustic_conv_plan(self, device):
        return 0, 0       # no conv FFN, no PostNet


def test_fused_call_counts_the_plan_once_a_call():
    """`make_fused_infer` counts `synth.amp_sites` / `synth.amp_sites_plain`
    once a call from the generator's plan (on the CPU: every site plain, 109
    for the large plan), none for a generator without one."""
    from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer

    mel = torch.randn(2, 6, 80, generator=torch.Generator().manual_seed(0)) - 4.0
    batch = {"audiotypes": None, "texts": mel, "src_lens": None}
    for preset, want in (("BigVGAN-large", (0, 109)), ("HiFi-GAN", (0, 0))):
        gen = get_vocoder(preset, upsample_initial_channel=64).eval()
        before = tracing.counters()
        out = make_fused_infer(_Mels(), gen)(batch)
        after = tracing.counters()
        got = tuple(after.get(k, 0) - before.get(k, 0)
                    for k in ("synth.amp_sites", "synth.amp_sites_plain"))
        assert got == want and out["wav"].shape == (2, 6 * 256)


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from visual_onoma_to_wave_tpu_torch.precision import pin_fp32

    pin_fp32()   # the plain versions' cuDNN convs in IEEE fp32, not TF32
    return torch.device("cuda")


def held_to_reference(got: torch.Tensor, want: torch.Tensor) -> None:
    """fp32 within 1e-5 of the scale; bf16 within one bf16 step of each
    element (or of 1% of the largest, for elements near zero, where the
    fp32 values both round carry the absolute error of __sinf and of the
    sums' order), on at most 2% of the elements apart at all."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * max(1.0, float(want.abs().max())))
        return
    w = want.float()
    step = torch.finfo(torch.bfloat16).eps * torch.maximum(w.abs(), 1e-2 * w.abs().max())
    diff = (got.float() - w).abs()
    assert bool((diff <= step).all()), float((diff / step).max())
    assert float((diff > 0).float().mean()) <= 0.02


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T", [1, 5, 2032, 4133, 6096])
@pytest.mark.parametrize("C", [24, 48, 96, 192, 384, 768])
def test_kernel_site_matches_its_plain_version(cuda, C, T, dtype):
    """One site at every width of the large preset, at T below the halo,
    exactly one tile, across tiles with a ragged end (rows of T % 8 != 0
    take the element-wise loads) and across three tiles of 16-byte rows, against
    `amp_act_reference` on the card (edges included) and against the fp32
    `SnakeAct` module."""
    site = randomised(SnakeAct(C), seed=C + T).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(C * T)
    x = (torch.randn(2, C, T, generator=g, device=cuda) * 3.0).to(dtype)
    before = amp.amp_act.launches
    with torch.inference_mode():
        got = amp.amp_act(x, site.log_alpha, site.log_beta)
        want = amp.amp_act_reference(x, site.log_alpha, site.log_beta)
        module = site(x.float())
    torch.cuda.synchronize()
    assert amp.amp_act.launches == before + 1 and got.dtype == dtype
    held_to_reference(got, want)
    torch.testing.assert_close(got.float(), module, rtol=0,
                               atol=(1e-5 if dtype == torch.float32 else 2e-2) *
                               float(module.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_sum_stream_and_mean_modes(cuda, dtype):
    """The launch that adds g and a bias into its operand, writes the
    stream and activates it, and the one that writes the three streams'
    mean, against `amp_operand` and `amp_act_reference`."""
    C, T = 48, 3000
    g = torch.Generator(device=cuda).manual_seed(1)
    x, h, m0, m1 = (torch.randn(3, C, T, generator=g, device=cuda).to(dtype) for _ in range(4))
    bias = torch.randn(C, generator=g, device=cuda)
    la, lb = (torch.rand(C, generator=g, device=cuda) - 0.5 for _ in range(2))
    with torch.inference_mode():
        p, a, _ = amp.amp_launch(x, la, lb, g=h, bias=bias, y=True)
        _, _, mean = amp.amp_launch(x, g=h, bias=bias, act=False, mean=(m0, m1))
        p_want = amp.amp_operand(x, h, bias)
        a_want = amp.amp_act_reference(p_want, la, lb)
        mean_want = ((m0.float() + m1.float() + p_want.float()) * (1.0 / 3)).to(dtype)
    torch.cuda.synchronize()
    assert torch.equal(p, p_want)
    assert torch.equal(mean, mean_want)
    held_to_reference(a, a_want)


def large_stage(C: int, dtype: torch.dtype, device) -> torch.nn.ModuleList:
    """A stage of the large preset at width C, weights of the cell's scale."""
    blocks = torch.nn.ModuleList(AMPBlock1(C, k, d, dtype=dtype) for k, d in zip(KS, DS))
    return randomised(blocks, seed=C, std=1.0 / (C * 7) ** 0.5).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("C,frames", LARGE_STAGES)
def test_amp_op_matches_the_modules_at_each_stage_shape(cuda, C, frames):
    """The AMP op (bf16, B 2, a quarter of the stage's frames of a
    1000-frame mel) against its plain version on the card (the same
    arithmetic: within 1e-2 relative RMS, cuDNN's and the CPU's sums
    differ in order) and against the modules: no further from the fp32
    modules than the bf16 modules are; in fp32 within 1e-4 of them."""
    T = frames // 4
    blocks = large_stage(C, torch.bfloat16, cuda)
    blocks32 = as_fp32(blocks)     # made outside inference mode: packing reads versions
    x = torch.randn(2, C, T, generator=torch.Generator(device=cuda).manual_seed(C), device=cuda)
    stages = mrf.MRFStages(KS, DS, act="snakebeta_aa")
    before = (mrf.mrf_stage_amp.launches, amp.amp_act.launches)
    with torch.inference_mode():
        got = stages(0, blocks, x.bfloat16())
        mats, biases, _, la, lb = stages.packed(0, blocks, torch.bfloat16)
        plain = mrf.amp_stage_reference(x.bfloat16(), mats, biases, la, lb)
        truth = sum(b(x) for b in blocks32) / 3
        mods = sum(b(x.bfloat16()) for b in blocks) / 3
        got32 = mrf.MRFStages(KS, DS, act="snakebeta_aa")(0, blocks32, x)
    torch.cuda.synchronize()
    assert (mrf.mrf_stage_amp.launches, amp.amp_act.launches) == (before[0] + 2,
                                                                   before[1] + 2 * 21)
    assert rel_rms(got, plain) < 1e-2
    assert rel_rms(got, truth) <= rel_rms(mods, truth), (rel_rms(got, truth), rel_rms(mods, truth))
    assert rel_rms(got32, truth) < 1e-4


@pytest.mark.gpu
def test_bigvgan_large_runs_every_site_through_the_kernel(cuda):
    """BigVGAN large in bf16 at its published widths, B 2 x 40 frames: 6
    AMP stages and 6 x 21 + 1 launches of the site kernel a forward, the
    waveform within 3% RMS of the fp32 modules' (no further than the bf16
    modules'), and the modules again in `.train()`."""
    torch.manual_seed(0)
    gen = get_vocoder("BigVGAN-large", dtype=torch.bfloat16)
    gen = randomised(gen, seed=1, std=0.02).to(cuda).eval()
    mel = torch.randn(2, 40, 80, generator=torch.Generator(device=cuda).manual_seed(0),
                      device=cuda)
    before = (mrf.mrf_stage_amp.launches, amp.amp_act.launches)
    with torch.inference_mode():
        got = gen(mel)
        torch.cuda.synchronize()
        launched = (mrf.mrf_stage_amp.launches - before[0], amp.amp_act.launches - before[1])
        gen32 = copy.deepcopy(gen)
        for m in gen32.modules():
            if hasattr(m, "dtype"):
                m.dtype = torch.float32
        gen32.train()
        truth = gen32(mel)
        gen.train()
        mods = gen(mel)
        gen.eval()
    assert launched == (6, 6 * 21 + 1)
    assert rel_rms(got, truth) <= max(rel_rms(mods, truth), 1e-3) and rel_rms(got, truth) < 0.03


@pytest.mark.gpu
def test_hifigan_v1_bf16_stage_launches_unchanged(cuda):
    """HiFi-GAN V1 in bf16 at B 16 x T 1000: 2 chain (C 256, 128), 1 unit
    (C 64) and 1 one-pass (C 32) stage a call, no AMP stage or site."""
    gen = get_vocoder("HiFi-GAN", dtype=torch.bfloat16).to(cuda).eval()
    mel = torch.randn(16, 1000, 80, generator=torch.Generator(device=cuda).manual_seed(0),
                      device=cuda) - 4.0
    counters = (mrf.mrf_stage_fused, mrf.mrf_stage_unit, mrf.mrf_stage_onepass,
                mrf.mrf_stage_amp, amp.amp_act)
    before = [c.launches for c in counters]
    with torch.inference_mode():
        gen(mel)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 1, 1, 0, 0]
