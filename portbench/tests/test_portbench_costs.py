"""The frozen operation and byte counters against hand counts at small
shapes, and each model family's FLOP counter (`reference/<family>.py`)
against a count of the port's own modules' products or by hand."""
from __future__ import annotations

import json

import pytest

from conftest import BENCH
from pbcore import costs, spec

FAM = {f: spec.load_module(BENCH / "reference" / f"{f}.py", "pbref_" + f)
       for f in ("icassp", "hifigan", "vocos")}


def test_bound_takes_the_larger_side():
    assert costs.bound_s(989e12, 1.0, "bfloat16") == pytest.approx(1.0)
    assert costs.bound_s(1.0, 3.35e12, "float32") == pytest.approx(1.0)
    assert costs.bound_s(495e12, 0.0, "float32") == pytest.approx(1.0)


def test_attention_cost_by_hand():
    # B 1, T 2, H 1, dk 2, 3 valid keys in all, fp32: QK^T and PV are 2 T Tk dk each
    flops, nbytes = costs.attention_cost(1, 2, 1, 2, 3, "float32")
    assert flops == 4 * 1 * 2 * 2 * 3
    # Q (2 x 2 floats) and ctx (the same) 16 bytes each, the mask 2 bytes,
    # K and V rows of the 3 valid keys 3 x 2 floats each
    assert nbytes == 16 + 2 + 16 + 2 * 3 * 2 * 4


def test_mrf_stage_cost_by_hand():
    # one branch, k 3, one dilation: two convs of 3 taps, C 2, B 1, T 5
    flops, nbytes = costs.mrf_stage_cost(1, 2, 5, "bfloat16", (3,), ((1,),))
    assert flops == 2 * (2 * 3) * 2 * 2 * 5
    assert nbytes == 2 * 2 * 5 * 2 + 2 * 3 * 2 * 2 * 2 + 2 * 2 * 4
    # HiFi-GAN's stage: 252 C^2 multiply-adds... 2 x 126 taps a frame
    flops, _ = costs.mrf_stage_cost(1, 4, 1, "float32")
    assert flops == 2 * 126 * 16


def test_convnext_block_cost_by_hand():
    flops, nbytes = costs.convnext_block_cost(1, 1, 2, 3, 7, "float32")
    assert flops == 4 * 2 * 3 + 2 * 7 * 2
    assert nbytes == 2 * 2 * 4 + (7 * 2 + 2 * 2 * 3) * 4 + (5 * 2 + 3) * 4


def test_fft_block_by_hand():
    # T 2, hidden 2, inner 3, kernels (1, 1): projections 4 x 2 T D D, scores and
    # context 4 T T D, FFN 2 T D I + 2 T I D
    assert FAM["icassp"].fft_block_flops(2, 2, 3, (1, 1)) == \
        4 * 2 * 2 * 2 * 2 + 4 * 4 * 2 + 2 * (2 * 2 * 2 * 3)


def _conv_macs(module, frames_in: int) -> float:
    """2 x multiply-adds of a torch conv / linear at `frames_in` input frames."""
    import torch

    if isinstance(module, torch.nn.ConvTranspose1d):
        c_in, c_out, k = module.weight.shape
        return 2.0 * frames_in * c_in * c_out * k
    if isinstance(module, torch.nn.Conv1d):
        c_out, c_in, k = module.weight.shape
        return 2.0 * frames_in * c_in * c_out * k
    raise TypeError(module)


def test_hifigan_flops_match_the_generator():
    """Every conv of the port's HiFi-GAN V1, counted at its own rate."""
    from visual_onoma_to_wave_tpu_torch.models import get_vocoder

    v = json.loads((BENCH / "configs" / "icassp_hifigan_v1.json").read_text())["vocoder"]
    gen = get_vocoder("HiFi-GAN")
    frames = 10
    total = _conv_macs(gen.conv_pre, frames)
    t = frames
    for i, up in enumerate(gen.ups):
        total += _conv_macs(up, t)
        t *= v["upsample_rates"][i]
        for block in gen.resblocks[i * 3:(i + 1) * 3]:
            for conv in list(block.convs1) + list(block.convs2):
                total += _conv_macs(conv, t)
    post = _conv_macs(gen.conv_post, t)
    parts = FAM["hifigan"].flops(v, frames)
    assert parts[0][0] == pytest.approx(total)
    assert parts[1][0] == pytest.approx(post)


def test_acoustic_flops_by_hand():
    ac = {"hidden": 2, "d_inner": 3, "ffn_kernel": [1, 1], "cell_hw": [1, 1], "vfe_layers": 1,
          "encoder_layers": 1, "decoder_layers": 1, "vp_filter": 2, "vp_kernel": 1,
          "n_mels": 1, "postnet_dim": 1, "dtype": "float32"}
    block = lambda t: FAM["icassp"].fft_block_flops(t, 2, 3, (1, 1))  # noqa: E731
    vfe = 1 * (2 * 9 * 1 + 2 * 1 * 2)
    predictors = 2 * (2 * 1 * 2 * 2 + 2 * 1 * 2 * 2 + 2 * 1 * 2)
    post = 5 * (2 * 4 * 1 * 1 * 5)
    want = vfe + block(1) + predictors + block(4) + 2 * 4 * 2 * 1 + post
    assert FAM["icassp"].flops(ac, 1, 4) == pytest.approx(want)


def test_request_time_at_peak_uses_each_dtype():
    cfg = json.loads((BENCH / "configs" / "icassp_vocos_mel.json").read_text())
    fam = {"acoustic": FAM["icassp"], "vocoder": FAM["vocos"]}
    t = costs.request_time_at_peak(cfg, fam, 8, 1000)
    ac = FAM["icassp"].flops(cfg["acoustic"], 8, 1000) / 495e12
    trunk, head = FAM["vocos"].flops(cfg["vocoder"], 1000)
    assert t == pytest.approx(ac + trunk[0] / 989e12 + head[0] / 495e12)
