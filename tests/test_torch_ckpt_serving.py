"""Serving a training checkpoint (`Synthesizer.from_checkpoint(restore_step=)`,
`--restore-step` on `synthesize`, `synthesize-batch`, `serve` and `export`),
on the CPU, and fault C5: the served vocabulary.

A tiny model is trained three steps by the port's `Trainer` on the examples'
synthetic corpus; a tiny HiFi-GAN (random weights) is its vocoder. Each
serving command resolves the checkpoint without `--acoustic` (the latest, or
the step named) and writes what the same command writes with the
checkpoint's `acoustic.npz` given as `--acoustic`, byte for byte;
`--acoustic` wins when both are given; a missing step exits naming the
checkpoint directory.

C5: the vocabulary comes from the checkpoint's `symbols.json` first, as the
JAX Synthesizer's `from_checkpoint` takes it (synthesis.py:159-161). The
corpus here is rebuilt after training with one more character, which
shifts every id; both packages' `Synthesizer.from_checkpoint` are built on
the same directories (JAX's from the checkpoint's weights saved with its
own `save_params`) and must agree on the map and on the ids of a text.
"""
from __future__ import annotations

import base64
import http.client
import io
import json
import pathlib
import shutil
import wave

import numpy as np
import pytest
import torch

from test_torch_dataset import preprocessed_corpus
from visual_onoma_to_wave_tpu_torch.bridge import flatten_tree, load_npz, save_npz, vocoder_tree
from visual_onoma_to_wave_tpu_torch.cli import main
from visual_onoma_to_wave_tpu_torch.config import load_config
from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

SMALL = {"transformer": {"encoder_layer": 1, "decoder_layer": 1, "encoder_hidden": 32,
                         "decoder_hidden": 32, "conv_filter_size": 64,
                         "conv_kernel_size": [3, 1]},
         "visual_feature_extractor": {"layer_num": 2}, "variance_predictor": {"filter_size": 32},
         "max_seq_len": 128, "postnet_channels": 32,
         "vocoder_kwargs": {"upsample_initial_channel": 16}}
TEXT = "パンドン"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(config path, config, vocoder .npz) after 3 steps of the port's Trainer."""
    from visual_onoma_to_wave_tpu_torch.models.hifigan import HiFiGANGenerator
    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer

    root = tmp_path_factory.mktemp("served")
    path = pathlib.Path(preprocessed_corpus(root, n_per_class=6, batch_size=4))
    cfg = json.loads(path.read_text())
    cfg["model"] = SMALL
    cfg["train"]["max_mel_len"] = 256
    path.write_text(json.dumps(cfg))
    config = load_config(path)
    Trainer(config, device="cpu", loader_workers=0).train(max_steps=3)
    torch.manual_seed(0)
    gen = HiFiGANGenerator(upsample_initial_channel=16)
    save_npz(root / "vocoder.npz", vocoder_tree("HiFi-GAN", gen.state_dict()))
    return path, config, root / "vocoder.npz"


def _acoustic(config, step=3) -> pathlib.Path:
    return pathlib.Path(config.path.ckpt) / str(step) / "acoustic.npz"


def test_from_checkpoint_resolves_the_step(trained):
    _, config, _ = trained
    want = Synthesizer.from_checkpoint(config, str(_acoustic(config)), device="cpu")
    for step in (None, -1, 3):
        synth = Synthesizer.from_checkpoint(config, restore_step=step, device="cpu")
        sd, ref = synth.model.state_dict(), want.model.state_dict()
        assert all(torch.equal(sd[k], ref[k]) for k in ref)
    with pytest.raises(FileNotFoundError, match=str(pathlib.Path(config.path.ckpt))):
        Synthesizer.from_checkpoint(config, restore_step=99, device="cpu")


def _synthesize(path, out, *extra):
    main(["synthesize", str(path), "--text", TEXT, "--audiotype", "drum", "--out", str(out),
          "--device", "cpu", *extra])
    return pathlib.Path(out).read_bytes()


def test_cli_synthesize_serves_the_checkpoint(trained, tmp_path):
    path, config, voc = trained
    latest = _synthesize(path, tmp_path / "a.wav", "--restore-step", "-1", "--vocoder", str(voc))
    given = _synthesize(path, tmp_path / "b.wav", "--acoustic", str(_acoustic(config)),
                        "--vocoder", str(voc))
    assert latest == given and len(latest) > 44
    assert _synthesize(path, tmp_path / "c.wav", "--vocoder", str(voc)) == given


def test_cli_acoustic_wins_over_restore_step(trained, tmp_path):
    path, config, voc = trained
    tree = load_npz(_acoustic(config))
    flat = flatten_tree(tree)
    key = next(k for k in flat if k.endswith("mel_linear/bias"))
    flat[key] = flat[key] + 0.5
    save_npz(tmp_path / "other.npz", flat)
    both = _synthesize(path, tmp_path / "a.wav", "--acoustic", str(tmp_path / "other.npz"),
                       "--restore-step", "3", "--vocoder", str(voc))
    alone = _synthesize(path, tmp_path / "b.wav", "--acoustic", str(tmp_path / "other.npz"),
                        "--vocoder", str(voc))
    ckpt = _synthesize(path, tmp_path / "c.wav", "--restore-step", "3", "--vocoder", str(voc))
    assert both == alone != ckpt


@pytest.mark.parametrize("command", ["synthesize", "synthesize-batch", "serve", "export"])
def test_cli_missing_step_exits_naming_the_directory(trained, tmp_path, command):
    path, config, _ = trained
    args = {"synthesize": ["--text", TEXT, "--audiotype", "drum"],
            "synthesize-batch": [str(tmp_path / "rows.txt"), str(tmp_path / "out")],
            "serve": [], "export": ["--out", str(tmp_path / "art"), "--devices", "cpu"]}[command]
    (tmp_path / "rows.txt").write_text(f"{TEXT}\tdrum\n", encoding="utf-8")
    with pytest.raises(SystemExit) as e:
        main([command, str(path), *args, "--restore-step", "99", "--device", "cpu"])
    msg = str(e.value.code)
    assert "no checkpoint at step 99" in msg and str(pathlib.Path(config.path.ckpt)) in msg


def test_cli_synthesize_batch_serves_the_checkpoint(trained, tmp_path):
    path, config, voc = trained
    rows = tmp_path / "rows.txt"
    rows.write_text(f"{TEXT}\tdrum\nパン\tdrum\t1.2\n", encoding="utf-8")
    for name, extra in (("ckpt", ["--restore-step", "3"]),
                        ("given", ["--acoustic", str(_acoustic(config))])):
        assert main(["synthesize-batch", str(path), str(rows), str(tmp_path / name),
                     "--vocoder", str(voc), "--device", "cpu", *extra]) == 0
    names = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "given").iterdir()) and len(names) == 2
    for n in names:
        assert (tmp_path / "ckpt" / n).read_bytes() == (tmp_path / "given" / n).read_bytes()


def test_cli_serve_answers_from_the_checkpoint(trained, monkeypatch):
    from visual_onoma_to_wave_tpu_torch.serve import BatchingServer

    path, _, voc = trained
    started = []
    monkeypatch.setattr(BatchingServer, "serve_forever",
                        lambda self: (started.append(self), self.start()))
    main(["serve", str(path), "--restore-step", "-1", "--vocoder", str(voc), "--device", "cpu",
          "--port", "0"])
    srv = started[0]
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        conn.request("POST", "/v1/synthesize", json.dumps({"text": TEXT, "audiotype": "drum"}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        r = json.loads(resp.read())
        conn.close()
    finally:
        srv.stop()
    assert resp.status == 200, r
    assert len(r["durations"]) == len(TEXT)
    with wave.open(io.BytesIO(base64.b64decode(r["wav_b64"])), "rb") as w:
        assert w.getnframes() == r["mel_frames"] * 256


def test_cli_export_takes_the_checkpoint(trained, tmp_path):
    path, config, voc = trained
    main(["export", str(path), "--restore-step", "-1", "--vocoder", str(voc), "--out",
          str(tmp_path / "art"), "--devices", "cpu", "--max-batch", "1", "--text-lens", "4"])
    assert json.loads((tmp_path / "art" / "manifest.json").read_text())["buckets"]
    # the artifact carries the checkpoint's vocabulary
    ckpt_symbols = json.loads((pathlib.Path(config.path.ckpt) / "symbols.json").read_text())
    assert json.loads((tmp_path / "art" / "symbols.json").read_text()) == ckpt_symbols


def test_c5_the_checkpoint_vocabulary_is_served(trained, tmp_path):
    """The corpus rebuilt after training with one more character (sorted
    first, so every id shifts): both packages serve the checkpoint's map."""
    import jax

    from visual_onoma_to_wave_tpu.cli import load_config as jax_load_config
    from visual_onoma_to_wave_tpu.synthesis import Synthesizer as JaxSynthesizer
    from visual_onoma_to_wave_tpu.utils.checkpoint import save_params

    path, config, _ = trained
    pre = tmp_path / "preprocessed"
    shutil.copytree(config.path.preprocessed, pre)
    corpus = json.loads((pre / "symbols.json").read_text())
    rebuilt = {c: i + 1 for i, c in enumerate(sorted([*corpus, "ア"]))}
    (pre / "symbols.json").write_text(json.dumps(rebuilt, ensure_ascii=False))
    cfg = json.loads(path.read_text())
    cfg["path"]["preprocessed"] = str(pre)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    ckpt_symbols = json.loads((pathlib.Path(config.path.ckpt) / "symbols.json").read_text())
    assert rebuilt != ckpt_symbols

    synth = Synthesizer.from_checkpoint(load_config(tmp_path / "cfg.json"),
                                        str(_acoustic(config)), device="cpu")
    save_params(tmp_path / "acoustic", jax.tree.map(np.asarray, load_npz(_acoustic(config))))
    jsynth = JaxSynthesizer.from_checkpoint(jax_load_config(str(tmp_path / "cfg.json")),
                                            acoustic=str(tmp_path / "acoustic"), mesh=None)
    assert synth.symbol_map == jsynth.symbol_map == ckpt_symbols
    np.testing.assert_array_equal(synth._encode(TEXT), np.asarray(jsynth._encode(TEXT)))
    assert list(synth._encode(TEXT)) != [rebuilt.get(c, 0) for c in TEXT]
