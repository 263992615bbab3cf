"""The port's vocoder surface against the JAX package, on the CPU: receptive
halos, chunked vocoding, the family dispatch `vocoder_infer`,
`Synthesizer.vocode` and `cli synthesize-batch`.

Weights of the tiny generators are made with numpy from a seed
(`init_random`), given to JAX as they are and to the port through the
weight bridge; the demo cases use the committed checkpoints. Tolerances,
float32 on both sides, stated before the runs:

* halos: equal, for every preset of every family that has one;
* chunked vocoding: within 1e-5 of JAX's `vocoder_infer_chunked` over the
  whole length, and of the port's own full forward in the interior (a halo
  from each true edge; 2e-5 for BigVGAN, as tests/test_bigvgan.py), at
  weights of scale 0.1 (iSTFTNet: 0.05, the quiet case of
  tests/test_torch_istftnet.py) where the waveforms stay O(0.1-1);
* `Synthesizer.vocode` and `synthesize-batch` on the demo checkpoints: the
  golden waveform tolerance, 1e-5 absolute; the 16-bit files written from
  samples that agree within 1e-5 differ by at most one step of 1 / 32768.
"""
from __future__ import annotations

import argparse
import io
import pathlib
import sys
import types
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu.models import bigvgan as jbigvgan
from visual_onoma_to_wave_tpu.models import hifigan as jhifigan
from visual_onoma_to_wave_tpu.models import istftnet as jistftnet
from visual_onoma_to_wave_tpu.models import melgan as jmelgan
from visual_onoma_to_wave_tpu.models import vocoder as jvocoder
from visual_onoma_to_wave_tpu.models import vocos as jvocos
from visual_onoma_to_wave_tpu_torch import cli as tcli
from visual_onoma_to_wave_tpu_torch.bridge import load_npz, melgan_state_dict, vocoder_state_dict
from visual_onoma_to_wave_tpu_torch.models import (
    BigVGANGenerator,
    HiFiGANGenerator,
    MelGANGenerator,
    VocosGenerator,
    build_istftnet,
    get_vocoder,
    vocoder_infer,
)
from visual_onoma_to_wave_tpu_torch.models.hifigan import (
    HIFIGAN_PRESETS,
    generator_halo_frames,
    receptive_halo_frames,
    vocoder_infer_chunked,
)
from visual_onoma_to_wave_tpu_torch.models.melgan import LN10
from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples"))
import export_demo_for_torch as export  # noqa: E402
from test_torch_layers import init_random  # noqa: E402

HOP = 256
DEMO_VOCODERS = {"HiFi-GAN": ("config.json", "vocoder", "golden.npz"),
                 "Vocos": ("config_vocos.json", "vocoder_vocos", "golden_vocos.npz"),
                 "iSTFTNet-mel": ("config_istftnet.json", "vocoder_istftnet_mel",
                                  "golden_istftnet.npz")}


@pytest.mark.parametrize("name", ["HiFi-GAN", "HiFi-GAN_v2", "HiFi-GAN_v3", "iSTFTNet",
                                  "iSTFTNet-mel", "Vocos", "BigVGAN", "BigVGAN-large"])
def test_receptive_halo_frames_equal_jax(name):
    """Every preset of every family with a halo, and BigVGAN without AA."""
    for kw in ({}, {"anti_aliased": False}) if name.startswith("BigVGAN") else ({},):
        jgen = jvocoder.get_vocoder(name, **kw)
        want = (jgen.receptive_halo_frames() if hasattr(jgen, "receptive_halo_frames") else
                jhifigan.receptive_halo_frames(
                    jgen.upsample_rates, jgen.upsample_kernel_sizes, jgen.resblock_kernel_sizes,
                    jgen.resblock_dilations, resblock_type=jgen.resblock_type))
        assert generator_halo_frames(get_vocoder(name, **kw)) == want, (name, kw)


def test_receptive_halo_function_equals_jax():
    v3 = {k: v for k, v in HIFIGAN_PRESETS["v3"].items() if k != "upsample_initial_channel"}
    for kw in ({}, v3, {"pre_kernel": 5, "post_kernel": 9},
               {"resblock_type": "2", "resblock_dilations": ((1, 2, 4),) * 3}):
        assert receptive_halo_frames(**kw) == jhifigan.receptive_halo_frames(**kw), kw


# family -> (JAX generator, port generator, bridge family name, interior
# tolerance, weight scale)
CHUNKED = {
    "hifigan-v1": (lambda: jhifigan.HiFiGANGenerator(upsample_initial_channel=16),
                   lambda: HiFiGANGenerator(upsample_initial_channel=16), "HiFi-GAN", 1e-5, 0.1),
    "hifigan-v3": (lambda: jhifigan.HiFiGANGenerator(**{**HIFIGAN_PRESETS["v3"],
                                                        "upsample_initial_channel": 16}),
                   lambda: HiFiGANGenerator(**{**HIFIGAN_PRESETS["v3"],
                                               "upsample_initial_channel": 16}),
                   "HiFi-GAN_v3", 1e-5, 0.1),
    "istftnet-c8c8i": (lambda: jistftnet.build_istftnet("c8c8i", upsample_initial_channel=64),
                       lambda: build_istftnet("c8c8i", upsample_initial_channel=64),
                       "iSTFTNet", 1e-5, 0.05),
    "istftnet-mel": (lambda: jistftnet.build_istftnet("melrate", upsample_initial_channel=32),
                     lambda: build_istftnet("melrate", upsample_initial_channel=32),
                     "iSTFTNet-mel", 1e-5, 0.05),
    "vocos": (lambda: jvocos.VocosGenerator(dim=32, intermediate_dim=64, num_layers=2),
              lambda: VocosGenerator(dim=32, intermediate_dim=64, num_layers=2), "Vocos", 1e-5, 0.1),
    "bigvgan": (lambda: jbigvgan.BigVGANGenerator(upsample_initial_channel=16,
                                                  resblock_kernel_sizes=(3,),
                                                  resblock_dilations=((1, 2),)),
                lambda: BigVGANGenerator(upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                                         resblock_dilations=((1, 2),)), "BigVGAN", 2e-5, 0.1),
}


@pytest.mark.parametrize("family", list(CHUNKED))
def test_chunked_vocoding_matches_jax_and_the_full_forward(family):
    make_jax, make_port, bridge_name, interior_tol, scale = CHUNKED[family]
    rng = np.random.default_rng(11)
    jgen, gen = make_jax(), make_port().eval()
    halo = generator_halo_frames(gen)
    T = 2 * halo + 45           # a ragged last chunk and an interior
    mel = rng.normal(-1, 1, (2, T, 80)).astype(np.float32)
    variables = init_random(jgen, rng, jnp.asarray(mel[:, :8]), scale=scale)
    gen.load_state_dict(vocoder_state_dict(bridge_name, jax.tree.map(np.asarray, variables)))
    ref = np.asarray(jhifigan.vocoder_infer_chunked(variables, jnp.asarray(mel),
                                                    chunk_frames=32, gen=jgen))
    x = torch.from_numpy(mel)
    out = vocoder_infer_chunked(gen, x, chunk_frames=32).numpy()
    with torch.no_grad():
        full = gen(x).numpy()
    assert out.shape == ref.shape == full.shape == (2, T * HOP)
    assert 0.01 < np.abs(ref).max() < 10
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    h = halo * HOP
    np.testing.assert_allclose(out[:, h:-h], full[:, h:-h], rtol=0, atol=interior_tol)


def test_chunked_vocoding_takes_an_explicit_halo_and_raises_for_melgan():
    gen = get_vocoder("HiFi-GAN", upsample_initial_channel=16).eval()
    mel = torch.randn(1, 40, 80, generator=torch.Generator().manual_seed(0))
    assert vocoder_infer_chunked(gen, mel, chunk_frames=16, halo_frames=2).shape == (1, 40 * HOP)
    with pytest.raises(ValueError, match="MelGAN"):
        vocoder_infer_chunked(MelGANGenerator(ngf=8).eval(), mel)
    with pytest.raises(ValueError, match="MelGAN"):
        vocoder_infer_chunked(MelGANGenerator(ngf=8).eval(), mel, halo_frames=4)


@pytest.mark.parametrize("family", ["HiFi-GAN", "MelGAN"])
def test_vocoder_infer_matches_jax(family):
    """The one family dispatch: (wavs, per-item samples), MelGAN fed log10."""
    rng = np.random.default_rng(13)
    mel = rng.normal(-4, 1, (2, 12, 80)).astype(np.float32)
    if family == "MelGAN":
        jgen, gen = jmelgan.MelGANGenerator(ngf=8), MelGANGenerator(ngf=8)
    else:
        jgen, gen = (jhifigan.HiFiGANGenerator(upsample_initial_channel=16),
                     HiFiGANGenerator(upsample_initial_channel=16))
    variables = init_random(jgen, rng, jnp.asarray(mel), scale=0.1)
    tree = jax.tree.map(np.asarray, variables)
    gen.load_state_dict(melgan_state_dict(tree) if family == "MelGAN"
                        else vocoder_state_dict(family, tree))
    ref, ref_lens = jvocoder.vocoder_infer(variables, jnp.asarray(mel), [12, 5], gen=jgen)
    with torch.no_grad():
        wavs, lens = vocoder_infer(gen.eval(), torch.from_numpy(mel), [12, 5])
        _, whole = vocoder_infer(gen, torch.from_numpy(mel))
        if family == "MelGAN":
            np.testing.assert_array_equal(wavs.numpy(), gen(torch.from_numpy(mel) / LN10).numpy())
    np.testing.assert_array_equal(lens, np.asarray(ref_lens))
    np.testing.assert_array_equal(whole, [12 * HOP] * 2)
    np.testing.assert_allclose(wavs.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def _cut_mels(golden: dict) -> tuple[np.ndarray, np.ndarray]:
    """The golden requests' mels, each cut to its length and zero beyond."""
    lens = golden["mel_lens"].astype(int)
    mels = np.zeros((len(lens), int(lens.max()), golden["postnet_mel"].shape[-1]), np.float32)
    for i, n in enumerate(lens):
        mels[i, :n] = golden["postnet_mel"][i, :n]
    return mels, lens


@pytest.mark.parametrize("family", list(DEMO_VOCODERS))
def test_synthesizer_vocode_matches_jax(family):
    """The port's `Synthesizer.vocode` against the JAX `Synthesizer.vocode`
    run on the same weights (the method itself, on a stand-in for the
    instance that holds the config, the mel bucket and the vocoder)."""
    from visual_onoma_to_wave_tpu.synthesis import Synthesizer as JSynthesizer

    config, vocoder, golden = DEMO_VOCODERS[family]
    mels, lens = _cut_mels(dict(np.load(export.OUT / golden)))
    tree = load_npz(export.OUT / f"{vocoder}.npz")
    jcfg = export.demo_config(config)
    jgen = jvocoder.get_vocoder(jcfg.model.vocoder_model, **dict(jcfg.model.vocoder_kwargs))
    stand_in = types.SimpleNamespace(config=jcfg, mel_bucket=64, vocoder_params=tree,
                                     _vocoder_module=lambda: jgen)
    ref = JSynthesizer.vocode(stand_in, mels, lens)
    synth = Synthesizer.from_checkpoint(export.port_demo_config(config),
                                        str(export.OUT / "acoustic.npz"),
                                        str(export.OUT / f"{vocoder}.npz"), device="cpu")
    assert synth.mel_bucket == 64
    wavs = synth.vocode(mels, lens)
    for i, (w, r) in enumerate(zip(wavs, ref)):
        assert w.shape == (lens[i] * HOP,) == r.shape and np.isfinite(w).all()
        np.testing.assert_allclose(w, r, rtol=0, atol=1e-5, err_msg=f"{family} item {i}")


def test_synthesizer_vocode_needs_a_vocoder():
    synth = Synthesizer.from_checkpoint(export.port_demo_config(),
                                        str(export.OUT / "acoustic.npz"), device="cpu")
    with pytest.raises(ValueError, match="vocoder"):
        synth.vocode(np.zeros((1, 4, 80), np.float32), [4])


def test_read_batch_rows_formats_and_errors(tmp_path):
    """tests/test_cli_e2e.py's cases, and the port's rows equal JAX's."""
    from visual_onoma_to_wave_tpu.cli import _read_batch_rows as jax_rows

    p = tmp_path / "rows.txt"
    p.write_text("# comment\n\nclip_x|drum|24|font|パン\nドドド\tbell\t1.2\t0.8\nタン\tdrum\n",
                 encoding="utf-8")
    rows = tcli._read_batch_rows(p)
    assert rows[0] == {"name": "clip_x", "text": "パン", "audiotype": "drum", "d": 1.0, "e": 1.0}
    assert rows[1]["text"] == "ドドド" and rows[1]["d"] == 1.2 and rows[1]["e"] == 0.8
    assert rows[2] == {"name": "00004", "text": "タン", "audiotype": "drum", "d": 1.0, "e": 1.0}
    assert rows == jax_rows(p)
    p.write_text("a|b|c\n", encoding="utf-8")
    with pytest.raises(ValueError, match="5 .-separated fields"):
        tcli._read_batch_rows(p)
    p.write_text("textonly\n", encoding="utf-8")
    with pytest.raises(ValueError, match="TSV rows"):
        tcli._read_batch_rows(p)


def _pcm16(path: pathlib.Path) -> np.ndarray:
    with wave.open(io.BytesIO(path.read_bytes())) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 22050)
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)


def test_synthesize_batch_matches_jax(tmp_path, monkeypatch, capsys):
    """`cli synthesize-batch --device cpu` on the demo checkpoint against the
    JAX command on the same rows: the same files (named rows, a sanitised
    name, TSV line numbers), the same summary counts, the float samples
    handed to `write_wav` within 1e-5, the 16-bit files within one step."""
    import visual_onoma_to_wave_tpu.cli as jcli
    import visual_onoma_to_wave_tpu.data.audio_io as jaudio
    import visual_onoma_to_wave_tpu_torch.data.audio_io as taudio

    rows = tmp_path / "rows.txt"
    rows.write_text("# demo rows\n"
                    "clip/a b|bell|24||バウバウ\n"
                    "チパチパチパ\tdrum\t1.0\t1.2\n"
                    "パシウドパシウド\tbell\t0.8\n"
                    "シトパリ\tdrum\n"
                    "パン\tbell\t1.3\t0.9\n", encoding="utf-8")
    samples: dict[str, dict[str, np.ndarray]] = {"jax": {}, "port": {}}

    def capture(side, write):
        def spy(path, audio, sr):
            samples[side][pathlib.Path(path).name] = np.asarray(audio, np.float32)
            write(path, audio, sr)
        return spy

    demo = export.DEMO
    monkeypatch.setattr(jaudio, "write_wav", capture("jax", jaudio.write_wav))
    assert jcli.cmd_synthesize_batch(argparse.Namespace(
        config=str(demo / "config.json"), input=str(rows), out_dir=str(tmp_path / "jax"),
        batch_size=4, e_control=1.1, d_control=0.9, restore_step=None,
        vocoder=str(demo / "vocoder"), acoustic=str(demo / "acoustic"))) == 0
    jax_summary = capsys.readouterr().out
    monkeypatch.setattr(taudio, "write_wav", capture("port", taudio.write_wav))
    assert tcli.main(["synthesize-batch", str(demo / "config.json"), str(rows),
                      str(tmp_path / "port"), "--acoustic", str(export.OUT / "acoustic.npz"),
                      "--vocoder", str(export.OUT / "vocoder.npz"), "--batch-size", "4",
                      "--e-control", "1.1", "--d-control", "0.9", "--device", "cpu"]) == 0
    port_summary = capsys.readouterr().out
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(samples["jax"])
    assert names == ["00002.wav", "00003.wav", "00004.wav", "00005.wav", "clip_a_b.wav"]
    assert jax_summary.split(" (")[0] == port_summary.split(" (")[0] == \
        "wrote 5 wavs"
    for name in names:
        got, want = samples["port"][name], samples["jax"][name]
        assert got.shape == want.shape and got.shape[0] % HOP == 0, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
        assert np.abs(_pcm16(tmp_path / "port" / name) - _pcm16(tmp_path / "jax" / name)).max() <= 1
