"""The plain reference against the port on the CPU at a tiny size, with the
benchmark's own weights: the renderer bit for bit, the acoustic model, and
both vocoder families (this test imports both sides; the reference itself
imports nothing of the port)."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from conftest import BENCH
from pbcore import program, spec, weights

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def load(name: str) -> dict:
    return json.loads((BENCH / "tests" / f"{name}.json").read_text())


def families(cfg: dict) -> dict:
    return {part: spec.load_module(BENCH / "reference" / f"{cfg[part]['family']}.py",
                                   "pbref_" + cfg[part]["family"])
            for part in ("acoustic", "vocoder")}


def made(cfg: dict, fam: dict, seed: int = 7):
    aw = weights.make(fam["acoustic"].param_specs(cfg["acoustic"], cfg["init"]["acoustic"],
                                                  len(cfg["metadata"]["audiotypes"])),
                      seed, torch.device("cpu"), 0)
    vw = weights.make(fam["vocoder"].param_specs(cfg["vocoder"], cfg["init"]["vocoder"]),
                      seed, torch.device("cpu"), 1)
    return aw, vw


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("text,rates", [("アイウエオ", [1.0, 0.5, 2.0, 1.3, 0.7]),
                                        ("ドン", [4.0, 0.05])])
def test_renderer_bit_equal(text, rates):
    cfg = load("tiny_hifigan")
    fam = families(cfg)
    synth = program.build(cfg, *made(cfg, fam), torch.device("cpu"))
    got = synth._render_cells(text, rates)
    strip = fam["acoustic"].render(text, rates, cfg["acoustic"])
    assert np.array_equal(fam["acoustic"].cells_of(strip, len(text), 102), got)


@pytest.mark.parametrize("config", ["tiny_hifigan", "tiny_vocos"])
def test_reference_matches_port(config):
    cfg = load(config)
    fam = families(cfg)
    aw, vw = made(cfg, fam)
    synth = program.build(cfg, aw, vw, torch.device("cpu"))
    texts = ["アイウ", "パンパン", "ドン"]
    rates = [[1.0, 0.6, 1.4], [1.0, 0.5, 1.5, 0.5], [2.0, 0.8]]
    d_ctl, e_ctl = [0.3, 0.5, 0.7], [1.0, 1.2, 0.9]
    out = synth.synthesize_batch(texts, ["drum", "tear", "bells5"], width_rates=rates,
                                 e_control=e_ctl, d_control=d_ctl)
    ref = fam["acoustic"].Acoustic(aw, cfg["acoustic"], cfg["metadata"])
    c = 4
    cells = np.ones((3, c, 24, 102), np.float32)
    for i, (t, r) in enumerate(zip(texts, rates)):
        cells[i, :len(t)] = fam["acoustic"].cells_of(fam["acoustic"].render(t, r, cfg["acoustic"]),
                                                     len(t), 102)
    audiotypes = [cfg["metadata"]["audiotypes"].index(a) for a in ("drum", "tear", "bells5")]
    with torch.no_grad():
        enc = ref.encode(torch.from_numpy(cells), torch.tensor(audiotypes),
                         torch.tensor([3, 4, 2]), torch.tensor(e_ctl), torch.tensor(d_ctl))
        dec = ref.decode(enc["x"], enc["bucket"], enc["durations"])
        mel = dec["postnet_mel"]
        wav = fam["vocoder"].generate(vw, cfg["vocoder"], mel)
    for i, (t, res) in enumerate(zip(texts, out)):
        n, m = len(t), int(dec["mel_lens"][i])
        assert np.array_equal(res.durations, enc["durations"][i, :n].numpy())
        assert res.mel_len == m
        assert rel(res.energy, enc["energy"][i, :n]) < 1e-5
        assert rel(res.mel, mel[i, :m]) < 1e-5
        assert rel(res.wav, wav[i, :m * 256]) < 1e-4


def test_reference_crop_is_exact():
    """Vocoding mel_len + halo_frames frames gives the full buffer's samples."""
    for config in ("tiny_hifigan", "tiny_vocos"):
        cfg = load(config)
        fam = families(cfg)
        _, vw = made(cfg, fam)
        mel = torch.randn(1, 48, 80, generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            full = fam["vocoder"].generate(vw, cfg["vocoder"], mel)
            m = 12
            crop = fam["vocoder"].generate(vw, cfg["vocoder"],
                                           mel[:, :m + cfg["vocoder"]["halo_frames"]])
        assert torch.allclose(full[:, :m * 256], crop[:, :m * 256], rtol=0, atol=1e-6)
