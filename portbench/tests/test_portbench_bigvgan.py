"""BigVGAN large's configuration and reference (`configs/icassp_bigvgan_large.json`,
`reference/bigvgan.py`) on the CPU: the port against the reference at a
tiny width with the large plan; the crop at `halo_frames` exact; the
reference's parameter names and shapes the port's state_dict; every
activation site's input RMS within 0.1-10 under the configuration's
weights; a broken activation (alpha 10% off, one FIR's taps one place off,
both FIRs' taps two places off) past the `wav_gap` limit, and the one fault
found inside it (both FIRs one place off the same way); and a traced run of a tiny cell reading the two
AMP metrics. The reference imports nothing of the port
(`test_portbench_imports.py` loads every file of `reference/`).
"""
from __future__ import annotations

import contextlib
import io
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import run
from conftest import BENCH, TINY_MIXES, make_checkout
from pbcore import judge, program, spec, weights

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
REAL = json.loads((BENCH / "configs" / "icassp_bigvgan_large.json").read_text())
TINY = json.loads((BENCH / "tests" / "tiny_bigvgan.json").read_text())
REF = spec.load_module(BENCH / "reference" / "bigvgan.py", "pbref_bigvgan")


def vocoder_weights(cfg: dict, seed: int = 7) -> dict:
    return weights.make(REF.param_specs(cfg["vocoder"], cfg["init"]["vocoder"]), seed,
                        torch.device("cpu"), 1)


def cell_like_mels(b: int, t: int, seed: int = 0) -> torch.Tensor:
    """Mels with the moments of the cell's postnet mels (mean ~0.11, std
    ~1.02, read from the acoustic model at the cell's weights on the CPU)."""
    return torch.randn(b, t, 80, generator=torch.Generator().manual_seed(seed)) * 1.02 + 0.11


def test_reference_matches_port():
    """`synthesize_batch` of the port (its modules on the CPU, fp32) against
    the reference on the same seeded weights, as `test_reference_matches_port`
    holds the other two families."""
    cfg = TINY
    fam = {"acoustic": spec.load_module(BENCH / "reference" / "icassp.py", "pbref_icassp"),
           "vocoder": REF}
    aw = weights.make(fam["acoustic"].param_specs(cfg["acoustic"], cfg["init"]["acoustic"],
                                                  len(cfg["metadata"]["audiotypes"])),
                      7, torch.device("cpu"), 0)
    vw = vocoder_weights(cfg)
    synth = program.build(cfg, aw, vw, torch.device("cpu"))
    texts, rates = ["アイウ", "パンパン"], [[1.0, 0.6, 1.4], [1.0, 0.5, 1.5, 0.5]]
    out = synth.synthesize_batch(texts, ["drum", "tear"], width_rates=rates,
                                 e_control=[1.0, 1.2], d_control=[0.3, 0.5], return_mel=True)
    with torch.no_grad():
        for res in out:
            mel = torch.from_numpy(np.asarray(res.mel))[None]
            want = REF.generate(vw, cfg["vocoder"], mel)[0, :res.mel_len * 256].numpy()
            assert judge.rel_rms(res.wav, want) < 1e-5


@pytest.mark.parametrize("m", [5, 12])
def test_crop_is_exact_at_halo_frames(m):
    """Vocoding mel_len + halo_frames frames gives the full buffer's first
    mel_len x 256 samples (the large plan at a tiny width; the halo is a
    property of the plan, not of the width)."""
    v = TINY["vocoder"]
    assert v["halo_frames"] == REAL["vocoder"]["halo_frames"] >= 77
    vw = vocoder_weights(TINY)
    mel = cell_like_mels(1, m + v["halo_frames"] + 40)
    with torch.no_grad():
        full = REF.generate(vw, v, mel)
        crop = REF.generate(vw, v, mel[:, :m + v["halo_frames"]])
    assert torch.allclose(full[:, :m * 256], crop[:, :m * 256], rtol=0, atol=1e-6)
    with torch.no_grad():   # and one frame short of the receptive field is not exact
        short = REF.generate(vw, v, mel[:, :m + 2])
    assert not torch.allclose(full[:, :m * 256], short[:, :m * 256], rtol=0, atol=1e-6)


def test_param_specs_are_the_ports_state_dict():
    from visual_onoma_to_wave_tpu_torch.models import get_vocoder

    v = REAL["vocoder"]
    with torch.device("meta"):
        gen = get_vocoder(REAL["vocoder_model"], **{k: v[k] for k in REAL["vocoder_kwargs"]})
    want = {k: tuple(t.shape) for k, t in gen.state_dict().items()}
    got = {name: tuple(shape) for name, shape, *_ in REF.param_specs(v, REAL["init"]["vocoder"])}
    assert got == want
    assert abs(sum(math.prod(s) for s in got.values()) / 1e6 - 112.2) < 0.01


def site_inputs(v: dict, vw: dict, mel: torch.Tensor) -> dict:
    """Each activation site's input RMS in one reference forward."""
    rms, activation = {}, REF.activation

    def spy(p, name, x, q):
        rms[name] = float(x.pow(2).mean().sqrt())
        return activation(p, name, x, q)

    REF.activation = spy
    try:
        with torch.no_grad():
            wav = REF.generate(vw, v, mel)
    finally:
        REF.activation = activation
    return rms, wav


def test_every_site_sees_an_input_of_unit_scale():
    """At the configuration's weights and widths (48 frames of cell-like
    mels): every one of the 109 sites' input RMS within 0.1-10, and the
    waveform's RMS under 0.3."""
    rms, wav = site_inputs(REAL["vocoder"], vocoder_weights(REAL, seed=2400000001),
                           cell_like_mels(1, 48))
    assert len(rms) == 109
    assert 0.1 <= min(rms.values()) and max(rms.values()) <= 10.0, rms
    assert 0.03 < float(wav.pow(2).mean().sqrt()) < 0.3


def shift_site_fir(monkeypatch, op: str, by: int = 1) -> None:
    """Roll the taps of every site's upsampler (`op` "conv_transpose1d") or
    decimator ("conv1d") by `by` in the reference: its depthwise calls are
    the sites' FIRs, the grouped-by-channel ones."""
    real = getattr(REF.F, op)

    def rolled(x, w, *args, **kw):
        if kw.get("groups", 1) > 1:
            w = torch.roll(w, by, dims=-1)
        return real(x, w, *args, **kw)

    ops = {name: getattr(REF.F, name) for name in ("pad", "conv1d", "conv_transpose1d")}
    monkeypatch.setattr(REF, "F", SimpleNamespace(**{**ops, op: rolled}))


def broken_gap(fault: str, monkeypatch) -> float:
    """`wav_gap` of the reference with one activation fault against itself,
    at the configuration's widths and weights, 48 cell-like frames."""
    v, vw = REAL["vocoder"], vocoder_weights(REAL, seed=2400000002)
    mel = cell_like_mels(1, 48, seed=1)
    with torch.no_grad():
        want = REF.generate(vw, v, mel)
        bad = vw
        if fault == "alpha_10pc":
            bad = {k: t + math.log(1.1) if k.endswith("log_alpha") else t for k, t in vw.items()}
        elif fault == "up_fir_one_tap":
            shift_site_fir(monkeypatch, "conv_transpose1d")
        elif fault == "down_fir_one_tap":
            shift_site_fir(monkeypatch, "conv1d")
        else:       # both FIRs' taps rolled the same way: "fir_shifted" two, "fir_both_one" one
            monkeypatch.setattr(REF, "FIR", np.roll(REF.FIR, 2 if fault == "fir_shifted" else 1))
        got = REF.generate(bad, v, mel)
    return judge.rel_rms(got.numpy(), want.numpy())


@pytest.mark.parametrize("fault", ["alpha_10pc", "fir_shifted", "up_fir_one_tap",
                                   "down_fir_one_tap"])
def test_a_broken_activation_fails_the_wav_limit(fault, monkeypatch):
    """Past the `wav_gap` limit: every alpha 10% high (~0.8); the taps of
    both FIRs two places round (~0.17); the upsampler's or the decimator's
    taps alone one place round (~1.35: the site's output half a sample off,
    the likeliest fault of a kernel's polyphase indexing)."""
    assert broken_gap(fault, monkeypatch) > REAL["limits"]["wav_gap"]


def test_a_compensating_one_tap_shift_is_inside_the_wav_limit(monkeypatch):
    """What `correct` cannot see: both FIRs' taps one place round the same
    way (the upsampler's delay and the decimator's advance cancel) read
    ~0.05, inside the 0.12 limit that bf16's own ~0.07 sets. A site then
    differs from the right one by ~4e-3 relative RMS on white noise, past
    the one bf16 step a site is held to on the card (`tests/
    test_torch_amp.py`, `chip_smoke.py` phase 14b): those catch it, the
    cell's judge does not."""
    assert 0.02 < broken_gap("fir_both_one", monkeypatch) < REAL["limits"]["wav_gap"]


def test_traced_tiny_cell_reads_the_amp_metrics(tmp_path):
    """A traced CPU run of a tiny BigVGAN cell: correct; every site counted
    plain (the CPU runs the modules), so `amp_fused_site_share.offline`
    reads 0; no device time under the op, so `amp_roofline_share.offline`
    is left out."""
    root = make_checkout(tmp_path)
    (root / BENCH.name / "configs" / "tiny_bigvgan.json").write_text(json.dumps(TINY))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_bigvgan", "source": "https://arxiv.org/abs/2206.04658",
                             "file": f"{BENCH.name}/configs/tiny_bigvgan.json", "reduced": [],
                             "why": "CPU-sized"})
    bench["workloads"].append({"name": "tiny.bigvgan_offline", "config": "tiny_bigvgan",
                               "traffic": next(iter(TINY_MIXES)), "chips": 1, "why": "CPU-sized"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "bigvgan_large.batch64_full" in m["workloads"]:
            m["workloads"].append("tiny.bigvgan_offline")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run.main(["--workload", "tiny.bigvgan_offline", "--seed", "3000000123",
                         "--seconds", "1", "--trace", "1"], device="cpu", root=root) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    m = res["metrics"]
    assert m["amp_fused_site_share.offline"]["value"] == 0.0
    assert "amp_roofline_share.offline" not in m
    assert {"vocoder_device_ms.offline", "mfu.offline"} <= set(m)
