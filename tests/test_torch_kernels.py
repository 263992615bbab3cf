"""The port's kernel wrappers (`visual_onoma_to_wave_tpu_torch/ops/`).

No JAX here, so the file also runs on a machine with a GPU and no JAX:

    python -m pytest tests/test_torch_kernels.py -q     # on the card

On the CPU a wrapper takes its plain PyTorch version and counts no launch;
on any other non-CUDA device it raises. The tests marked `gpu` compare
each CUDA kernel with its plain version on the card and skip without one.
Attention tolerances: fp32 1e-5 absolute (summation order and the kernel's
3xTF32 products); bf16 2e-2 absolute plus one bf16 ulp relative
(probabilities rounded at other points, both results rounded to bf16), at
chip_smoke's `ATTN_T` around the 64-key tile, with tail and "holes" masks.
ConvNeXt tolerances are chip_smoke's `convnext_atol` (fp32 5e-5 absolute for |y| up to ~6, summation order over
the C and M products; bf16 within 0.03 of max |plain|, the JAX package's
bound for this kernel, since rounding flips carry from layer to layer), and
the trunk must equal L block launches exactly. Mel frontend bounds are
chip_smoke's `check_mel_frontend` / `check_clip_features` (log-mel 1e-4
absolute, the JAX package's 2e-3 + 1e-4 |ref| for the full-scale case where
fp32 spectra sit at their rounding noise; frame sums 1e-5 relative; kurtosis
1e-4 + 1e-4 |ref|), over the case grid of tests/test_pallas_mel.py, and
its log-mel within 1e-5 of float64 (`check_mel_float64`), there and over
chip_smoke's n_fft sweep (16 ... 2048, B 3, two clip lengths). Fused
MRF stage bounds are chip_smoke's `MRF_OF_SCALE` (fp32 1e-5 x max |plain|,
summation order over 18 convs; bf16 2e-2 x max |plain|, rounding flips of the
bf16 conv inputs carried by the later convs); the iSTFTNet generators on the
card against their CPU path (the ResBlock1 modules) within 1e-4 x max |CPU|.
"""
from __future__ import annotations

import pytest
import torch

import chip_smoke
from visual_onoma_to_wave_tpu_torch.ops.attention import attention_core, attention_core_reference
from visual_onoma_to_wave_tpu_torch.ops.convnext import (
    convnext_block,
    convnext_block_reference,
    convnext_trunk,
    convnext_trunk_reference,
    pack_convnext_weights,
)
from visual_onoma_to_wave_tpu_torch.ops.mel import (
    fused_clip_features,
    mel_frontend,
    mel_frontend_reference,
)
from visual_onoma_to_wave_tpu_torch.ops.mrf import (
    ONEPASS_KERNEL_WIDTHS,
    UNIT_KERNEL_WIDTHS,
    _mrf_stage_chain,
    mrf_route,
    mrf_stage_fused,
    mrf_stage_fused_reference,
    mrf_stage_onepass,
    mrf_stage_unit,
    onepass_tile_frames,
    pack_mrf_kernel_weights,
    sm_count,
    tile_frames,
    unit_tile_frames,
)
from visual_onoma_to_wave_tpu_torch.ops.stft import char_stats_from_frame_sums

MEL_CASES = [pytest.param(*case, id=case[0]) for case in chip_smoke.mel_cases()]
MEL_SWEEP = [pytest.param(*case, id=case[0]) for case in chip_smoke.mel_sweep_cases()]


def _mask(lens, T, device=None) -> torch.Tensor:
    return torch.arange(T, device=device)[None, :] >= torch.tensor(lens, device=device)[:, None]


def test_cpu_tensors_take_the_plain_version():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 10, 128, generator=g) for _ in range(3))
    mask = _mask([10, 4], 10)
    before = attention_core.launches
    out = attention_core(q, k, v, mask, 2)
    assert attention_core.launches == before     # no kernel launch counted
    assert torch.equal(out, attention_core_reference(q, k, v, mask, 2))


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty(2, 10, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_core(q, q, q, None, 2)


def _convnext(L, C, M, T, device="cpu", seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    ws = chip_smoke.convnext_weights(L, C, M, g, device)
    return torch.randn(2, T, C, generator=g, device=device), ws


def test_convnext_cpu_tensors_take_the_plain_versions():
    x, ws = _convnext(3, 128, 256, 20)
    counts = convnext_block.launches, convnext_trunk.launches
    block = convnext_block(x, *[w[0] for w in ws], gelu_approximate=False)
    trunk = convnext_trunk(x, *ws)
    assert (convnext_block.launches, convnext_trunk.launches) == counts
    assert torch.equal(block, convnext_block_reference(x, *[w[0] for w in ws],
                                                       gelu_approximate=False))
    assert torch.equal(trunk, convnext_trunk_reference(x, *ws))


def test_convnext_other_devices_raise_instead_of_falling_back():
    x, ws = _convnext(2, 128, 256, 8)
    x, ws = x.to("meta"), [w.to("meta") for w in ws]
    with pytest.raises(ValueError, match="unsupported device"):
        convnext_block(x, *[w[0] for w in ws])
    with pytest.raises(ValueError, match="unsupported device"):
        convnext_trunk(x, *ws)


def test_mel_frontend_cpu_tensors_take_the_plain_version():
    _, prepadded, win = chip_smoke.mel_cases()[0]
    x = torch.from_numpy(prepadded)
    d = torch.from_numpy(chip_smoke.mel_durations(x.shape[0], (x.shape[1] - 1024) // 256 + 1))
    before = mel_frontend.launches
    got = mel_frontend(x, win_length=win)
    features = fused_clip_features(x, d, 8, win_length=win)
    assert mel_frontend.launches == before
    ref = mel_frontend_reference(x, win_length=win)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    char_e, kurt = char_stats_from_frame_sums(*ref[1:], d, max_chars=8, n_freqs=513)
    assert torch.equal(features[0], ref[0])
    assert torch.equal(features[1], char_e) and torch.equal(features[2], kurt)


@pytest.mark.parametrize("shape,dtype,kwargs,error,match", [
    ((2, 4096), torch.float32, {"n_fft": 1000}, ValueError, "power of two"),
    ((2, 4096), torch.float32, {"n_fft": 4096, "win_length": 4096}, ValueError, "power of two"),
    ((2, 4096), torch.float32, {"win_length": 2048}, ValueError, "win_length"),
    ((2, 4096), torch.float32, {"hop_length": 0}, ValueError, "hop"),
    ((4096,), torch.float32, {}, ValueError, r"\(B, L\)"),
    ((2, 4096), torch.float64, {}, ValueError, "float32"),
    ((2, 1000), torch.float32, {}, ValueError, "at least"),
    ((2, 4096), torch.float32, {}, ValueError, "unsupported device"),
], ids=["n_fft_1000", "n_fft_4096", "window_over_n_fft", "hop_0", "one_dim", "float64",
        "shorter_than_n_fft", "meta_device"])
def test_mel_frontend_refuses_what_the_kernel_does_not_take(shape, dtype, kwargs, error, match):
    with pytest.raises(error, match=match):
        mel_frontend(torch.empty(shape, dtype=dtype, device="meta"), **kwargs)


def test_mel_frontend_refuses_a_call_that_needs_a_gradient():
    x = torch.empty(2, 4096, device="meta", requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        mel_frontend(x)


def test_mrf_cpu_tensors_take_the_plain_version():
    g = torch.Generator().manual_seed(2)
    mats, bias = chip_smoke.mrf_weights(32, g, "cpu")
    x = torch.randn(2, 32, 40, generator=g)
    before = mrf_stage_fused.launches
    out = mrf_stage_fused(x, *mats, bias)
    assert mrf_stage_fused.launches == before
    assert torch.equal(out, mrf_stage_fused_reference(x, *mats, bias))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from visual_onoma_to_wave_tpu_torch.precision import pin_fp32

    pin_fp32()   # the plain versions' cuDNN convs in IEEE fp32, not TF32
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("holes", [False, True], ids=["tail", "holes"])
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0),
                                             (torch.bfloat16, 2e-2, 2.0 ** -7)])
@pytest.mark.parametrize("dk", [64, 128])
@pytest.mark.parametrize("T", chip_smoke.ATTN_T)
def test_attention_kernel_matches_plain(cuda, T, dk, dtype, atol, rtol, holes):
    g = torch.Generator(device=cuda).manual_seed(T + dk)
    q, k, v = (torch.randn(3, T, 2 * dk, generator=g, device=cuda).to(dtype) for _ in range(3))
    mask = _mask([T, T // 3 + 1, 0], T, cuda)     # none, tail, fully padded
    if holes:   # and whole 64-key tiles of padding: 1, 3, ... of item 0, 0, 2, ... of item 1
        t = torch.arange(T, device=cuda)[None, :]
        mask = mask | ((t // 64 + torch.arange(3, device=cuda)[:, None]) % 2 == 1)
    before = attention_core.launches
    out = attention_core(q, k, v, mask, 2)
    ref = attention_core_reference(q, k, v, mask, 2)
    torch.cuda.synchronize()
    assert attention_core.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    assert (out[2] == 0).all()


@pytest.mark.gpu
def test_attention_kernel_takes_views_off_the_16_byte_grid(cuda):
    # the kernel copies 16-byte chunks: the wrapper copies a view that starts
    # 4 bytes into its storage before the launch
    g = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(2 * 65 * 256 + 1, generator=g, device=cuda)[1:].view(2, 65, 256)
               for _ in range(3))
    assert q.data_ptr() % 16
    mask = _mask([65, 30], 65, cuda)
    torch.testing.assert_close(attention_core(q, k, v, mask, 2),
                               attention_core_reference(q, k, v, mask, 2), rtol=0.0, atol=1e-5)


@pytest.mark.gpu
def test_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 8, 2 * 32, device=cuda)
    with pytest.raises(ValueError, match="dk in"):
        attention_core(q, q, q, None, 2)                    # dk 32
    with pytest.raises(ValueError, match="float32/bfloat16"):
        attention_core(*(torch.randn(1, 8, 128, device=cuda).half(),) * 3, None, 2)
    q = torch.randn(1, 8, 128, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="inference-only"):
        attention_core(q, q, q, None, 2)                    # no backward


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("tanh", [True, False], ids=["tanh", "erf"])
@pytest.mark.parametrize("T", chip_smoke.CONVNEXT_T)
@pytest.mark.parametrize("C,M", chip_smoke.CONVNEXT_WIDTHS, ids=["demo", "full"])
def test_convnext_kernels_match_plain(cuda, C, M, T, tanh, dtype):
    x, ws = _convnext(8, C, M, T, cuda, seed=T + C)
    x = x.to(dtype)
    w0 = [w[0] for w in ws]
    counts = convnext_block.launches, convnext_trunk.launches
    block = convnext_block(x, *w0, gelu_approximate=tanh)
    trunk = {L: convnext_trunk(x, *[w[:L] for w in ws], gelu_approximate=tanh) for L in (4, 8)}
    torch.cuda.synchronize()
    assert (convnext_block.launches, convnext_trunk.launches) == (counts[0] + 1, counts[1] + 2)
    ref = convnext_block_reference(x, *w0, gelu_approximate=tanh)
    torch.testing.assert_close(block.float(), ref.float(), atol=chip_smoke.convnext_atol(ref),
                               rtol=0.0)
    for L, out in trunk.items():
        layers = [w[:L] for w in ws]
        ref = convnext_trunk_reference(x, *layers, gelu_approximate=tanh)
        torch.testing.assert_close(out.float(), ref.float(), atol=chip_smoke.convnext_atol(ref),
                                   rtol=0.0)
        blocks = x
        for layer in zip(*layers):
            blocks = convnext_block(blocks, *layer, gelu_approximate=tanh)
        assert torch.equal(out, blocks)


@pytest.mark.gpu
def test_convnext_kernels_reject_what_they_do_not_take(cuda):
    x, ws = _convnext(1, 128, 256, 8, cuda)
    w0 = [w[0] for w in ws]
    with pytest.raises(ValueError, match="C in"):
        convnext_block(x[..., :64], *[w[..., :64] if w.shape[-1] == 128 else w for w in w0])
    with pytest.raises(ValueError, match="multiple of 128"):
        convnext_block(x, *w0[:4], w0[4][:, :200], w0[5][:200], w0[6][:200], *w0[7:])
    with pytest.raises(ValueError, match="float32/bfloat16"):
        convnext_block(x.half(), *w0)
    with pytest.raises(ValueError, match="does not fit"):
        convnext_trunk(x, *ws[:4], ws[4][:, :, :128], *ws[5:])
    with pytest.raises(RuntimeError, match="inference-only"):
        convnext_block(x, *w0[:4], w0[4].clone().requires_grad_(), *w0[5:])
    with pytest.raises(ValueError, match="packed weights"):     # packed for another type
        convnext_block(x, *w0, packed=pack_convnext_weights(w0[4], w0[6], torch.bfloat16))
    with pytest.raises(ValueError, match="odd kernel size up to 35"):
        convnext_block(x, torch.randn(37, 1, 128, device=cuda), *w0[1:])


@pytest.mark.gpu
def test_convnext_kernels_take_packed_weights_as_packed_per_call(cuda):
    x, ws = _convnext(3, 512, 1536, 129, cuda, seed=5)
    w0 = [w[0] for w in ws]
    assert torch.equal(convnext_block(x, *w0, packed=pack_convnext_weights(w0[4], w0[6])),
                       convnext_block(x, *w0))
    assert torch.equal(convnext_trunk(x, *ws, packed=pack_convnext_weights(ws[4], ws[6])),
                       convnext_trunk(x, *ws))


@pytest.mark.gpu
@pytest.mark.parametrize("name,prepadded,win", MEL_CASES)
def test_mel_frontend_kernel_matches_plain(cuda, name, prepadded, win):
    x = torch.from_numpy(prepadded).to(cuda)
    d = torch.from_numpy(chip_smoke.mel_durations(x.shape[0], (x.shape[1] - 1024) // 256 + 1))
    d = d.to(cuda)
    before = mel_frontend.launches
    got = mel_frontend(x, win_length=win)
    features = fused_clip_features(x, d, 8, win_length=win)
    torch.cuda.synchronize()
    assert mel_frontend.launches == before + 2
    loose = name == "full_scale"
    chip_smoke.check_mel_frontend(name, chip_smoke._host(got),
                                  chip_smoke._host(mel_frontend_reference(x, win_length=win)),
                                  loose)
    chip_smoke.check_mel_float64(name, got[0].cpu().numpy(),
                                 chip_smoke.logmel_float64(x, win_length=win).cpu().numpy())
    chip_smoke.check_clip_features(name, chip_smoke._host(features),
                                   chip_smoke._host(chip_smoke.plain_clip_features(x, d, 8, win)),
                                   loose)


@pytest.mark.gpu
@pytest.mark.parametrize("name,clips,n_fft,hop", MEL_SWEEP)
def test_mel_frontend_kernel_matches_plain_and_float64_at_every_n_fft(cuda, name, clips, n_fft,
                                                                      hop):
    before = mel_frontend.launches
    chip_smoke.check_mel_sweep_case(cuda, clips, n_fft, hop)
    assert mel_frontend.launches == before + 1


@pytest.mark.gpu
def test_mel_frontend_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(2, 4096, device=cuda)
    with pytest.raises(ValueError, match="power of two"):
        mel_frontend(x, n_fft=1000)
    with pytest.raises(ValueError, match="float32"):
        mel_frontend(x.double())
    with pytest.raises(RuntimeError, match="inference-only"):
        mel_frontend(x.clone().requires_grad_())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("T", [20, 700, 1000, -1, 0, 1],
                         ids=["20", "700", "1000", "tile-1", "tile", "tile+1"])
@pytest.mark.parametrize("C", chip_smoke.MRF_WIDTHS)
def test_mrf_kernel_matches_plain(cuda, C, T, dtype):
    """T 20 lies inside the stage's 60-frame halo; -1 / 0 / 1 are frames
    around the kernel's time tile at width C (`tile_frames`)."""
    if T <= 1:
        T += tile_frames(C)
    g = torch.Generator(device=cuda).manual_seed(C + T)
    mats, bias = chip_smoke.mrf_weights(C, g, cuda)
    for B in (1, 4):
        x = torch.randn(B, C, T, generator=g, device=cuda)
        before = chip_smoke.launch_counts()
        out = mrf_stage_fused(x, *mats, bias, dtype=dtype)
        torch.cuda.synchronize()
        design = chip_smoke.MRF_RECORD[mrf_route(C, dtype, batch=B, frames=T,
                                                 sms=sm_count(x.device))]
        assert chip_smoke.launch_counts() == {**before, design: before[design] + 1}
        ref = mrf_stage_fused_reference(x, *mats, bias, dtype=dtype)
        assert out.dtype == ref.dtype == dtype and out.shape == ref.shape
        scale = ref.float().abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), rtol=0.0,
                                   atol=chip_smoke.MRF_OF_SCALE[dtype] * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [20, -1, 0, 1, 1000], ids=["20", "tile-1", "tile", "tile+1", "1000"])
@pytest.mark.parametrize("C", UNIT_KERNEL_WIDTHS)
def test_mrf_unit_design_equals_the_conv_chain(cuda, C, T):
    """The unit design sums in the conv chain's grouping and order: the two
    designs give the same bits (T -1 / 0 / 1: frames around the unit
    design's frame tile)."""
    if T <= 1:
        T += unit_tile_frames(C)
    g = torch.Generator(device=cuda).manual_seed(C + T)
    mats, bias = chip_smoke.mrf_weights(C, g, cuda)
    x = torch.randn(3, C, T, generator=g, device=cuda).to(torch.bfloat16)
    packed = pack_mrf_kernel_weights(mats, torch.bfloat16)
    bias = bias.float().contiguous()
    out = mrf_stage_unit(x, packed, bias)
    chain = _mrf_stage_chain(x, packed, bias, (3, 7, 11), ((1, 3, 5),) * 3)
    assert torch.equal(out, chain)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [20, -1, 0, 1, 1000], ids=["20", "tile-1", "tile", "tile+1", "1000"])
@pytest.mark.parametrize("C", ONEPASS_KERNEL_WIDTHS)
def test_mrf_onepass_kernel_equals_the_conv_chain(cuda, C, T):
    """The one-pass kernel sums in the conv chain's grouping and order: the
    two designs give the same bits (T -1 / 0 / 1: frames around the one-pass
    frame tile)."""
    if T <= 1:
        T += onepass_tile_frames(C)
    g = torch.Generator(device=cuda).manual_seed(C + T)
    mats, bias = chip_smoke.mrf_weights(C, g, cuda)
    x = torch.randn(3, C, T, generator=g, device=cuda).to(torch.bfloat16)
    packed = pack_mrf_kernel_weights(mats, torch.bfloat16)
    bias = bias.float().contiguous()
    out = mrf_stage_onepass(x, packed, bias)
    chain = _mrf_stage_chain(x, packed, bias, (3, 7, 11), ((1, 3, 5),) * 3)
    assert torch.equal(out, chain)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", [16, 64, 256])
@pytest.mark.parametrize("kernel_sizes,dilations", [
    ((1, 5, 9), ((1, 1, 1), (2, 4, 8), (3, 3, 3))),
    ((3, 3, 11), ((123, 1, 1), (1, 1, 1), (2, 2, 2))),
], ids=["k1-5-9", "halo128"])
def test_mrf_kernel_takes_other_kernel_sizes_and_dilations(cuda, kernel_sizes, dilations, C,
                                                           dtype):
    """Any odd k up to 11 and any dilations within the 128-frame halo: k 1
    (no halo), and a conv reaching 123 frames (the widest window the kernel
    stages)."""
    g = torch.Generator(device=cuda).manual_seed(C)
    mats = [(torch.randn(6, C, k * C, generator=g, device=cuda) * (0.5 / (k * C) ** 0.5))
            for k in kernel_sizes]
    bias = torch.randn(18, C, 1, generator=g, device=cuda) * 0.1
    x = torch.randn(2, C, 300, generator=g, device=cuda)
    out = mrf_stage_fused(x, *mats, bias, kernel_sizes, dilations, dtype=dtype)
    ref = mrf_stage_fused_reference(x, *mats, bias, kernel_sizes, dilations, dtype=dtype)
    scale = ref.float().abs().max().item()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0.0,
                               atol=chip_smoke.MRF_OF_SCALE[dtype] * scale)


@pytest.mark.gpu
def test_mrf_kernel_rejects_what_it_does_not_take(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    mats, bias = chip_smoke.mrf_weights(32, g, cuda)
    x = torch.randn(1, 32, 50, device=cuda)
    with pytest.raises(ValueError, match="C in"):
        mrf_stage_fused(x[:, :24], *[m[:, :24, :24] for m in mats], bias[:, :24])
    with pytest.raises(ValueError, match="halo"):
        mrf_stage_fused(x, *mats, bias, dilations=((9, 9, 9),) * 3)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        mrf_stage_fused(x, *mats, bias, dtype=torch.float16)
    with pytest.raises(RuntimeError, match="inference-only"):
        mrf_stage_fused(x.clone().requires_grad_(), *mats, bias)


@pytest.mark.gpu
@pytest.mark.parametrize("preset,stages", [("melrate", 1), ("c8c8i", 2)])
def test_istftnet_on_the_card_launches_one_mrf_kernel_per_stage(cuda, preset, stages):
    from visual_onoma_to_wave_tpu_torch.models import build_istftnet
    torch.manual_seed(0)
    gen = build_istftnet(preset, upsample_initial_channel=128 if preset == "c8c8i" else 64).eval()
    mel = torch.randn(2, 37, 80) - 3.0
    with torch.inference_mode():
        ref = gen(mel)
        gen.to(cuda)
        before = mrf_stage_fused.launches
        out = gen(mel.to(cuda))
        torch.cuda.synchronize()
    assert mrf_stage_fused.launches == before + stages
    torch.testing.assert_close(out.cpu(), ref, rtol=0.0, atol=1e-4 * ref.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("resblock,stages", [("1", 4), ("2", 0)], ids=["v1-v2", "v3"])
def test_hifigan_on_the_card_launches_one_mrf_kernel_per_resblock1_stage(cuda, resblock, stages):
    """ResBlock1 stages (V1 / V2) run through the MRF kernel, at the demo's
    widths (C 64 / 32 / 16 / 8); ResBlock2 stages (V3) stay on the modules."""
    from visual_onoma_to_wave_tpu_torch.models import get_vocoder
    torch.manual_seed(0)
    preset = "HiFi-GAN" if resblock == "1" else "HiFi-GAN-v3"
    gen = get_vocoder(preset, upsample_initial_channel=128).eval()
    mel = torch.randn(2, 23, 80) - 3.0
    with torch.inference_mode():
        ref = gen(mel)
        gen.to(cuda)
        before = mrf_stage_fused.launches
        out = gen(mel.to(cuda))
        torch.cuda.synchronize()
    assert mrf_stage_fused.launches == before + stages
    torch.testing.assert_close(out.cpu(), ref, rtol=0.0, atol=1e-4 * ref.abs().max().item())


@pytest.mark.gpu
def test_dropout_on_the_card_takes_a_cpu_generators_masks(cuda):
    """A CPU generator gives a model on the card the CPU's masks bit for bit;
    a CUDA generator the draw on the card, as before masks moved devices."""
    from visual_onoma_to_wave_tpu_torch.models.layers import Dropout

    x = torch.randn(4, 37, 16)
    d = Dropout(0.2).train()
    d.generator = torch.Generator().manual_seed(5)
    on_card = d.keep_mask(x.to(cuda))
    d.generator = torch.Generator().manual_seed(5)
    assert on_card.device.type == "cuda" and torch.equal(on_card.cpu(), d.keep_mask(x))
    d.generator = torch.Generator(device=cuda).manual_seed(5)
    want = torch.rand(x.shape, generator=torch.Generator(device=cuda).manual_seed(5),
                      device=cuda) >= 0.2
    assert torch.equal(d.keep_mask(x.to(cuda)), want)


@pytest.mark.gpu
@pytest.mark.parametrize("family,kw,kernel", [
    ("HiFi-GAN", dict(upsample_initial_channel=128), "mrf_stage"),
    ("iSTFTNet-mel", dict(upsample_initial_channel=64), "mrf_stage"),
    ("Vocos", dict(dim=128, intermediate_dim=384, num_layers=2), "convnext_block"),
])
def test_generators_launch_their_kernel_in_eval_only(cuda, family, kw, kernel):
    """In .train() a generator on the card takes the plain chain with
    autograd and launches no MRF or ConvNeXt kernel; in .eval() it does, and
    the two agree."""
    from visual_onoma_to_wave_tpu_torch.models import get_vocoder

    torch.manual_seed(0)
    gen = get_vocoder(family, **kw).to(cuda).train()
    mel = torch.randn(2, 23, 80, device=cuda) - 3.0
    before = chip_smoke.launch_counts()
    wav = gen(mel)
    wav.square().mean().backward()
    torch.cuda.synchronize()
    assert chip_smoke.launch_counts() == before
    assert all(p.grad is not None for p in gen.parameters())
    with torch.inference_mode():
        served = gen.eval()(mel)
    torch.cuda.synchronize()
    after = chip_smoke.launch_counts()
    assert after[kernel] > before[kernel]
    torch.testing.assert_close(served, wav.detach(), rtol=0.0,
                               atol=1e-4 * wav.detach().abs().max().item())
