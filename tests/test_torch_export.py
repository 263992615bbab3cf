"""The port's exported serving artifact (`export.py`) on the CPU.

The counterparts of the 11 tests of tests/test_export.py on the demo
checkpoint (`max_batch=4`, `text_lens=(4, 8)`): the manifest and files,
exported against live (bit-equal here: the same ops on the same inputs),
self-contained loading, bucket pad-up and limits, the HTTP edge's text cap,
`cli export --devices` validated before the checkpoint load, `cli serve
--exported`, `vocode()` live only, HTTP serving from the artifact. Beyond
them: the exported graph calls the kernels' custom ops by name (B1 once per
FFT block, B2 once per MRF stage, B4 once per ConvNeXt block of a Vocos
artifact); the port's artifact against JAX's `ExportedSynthesizer` on the
golden requests, within tests/test_torch_synthesis.py's golden tolerance
(durations and mel lengths exact, mel 1e-4 and waveform 1e-5 absolute); a
`cuda` artifact raises without a card.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import sys
from collections import Counter

import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu_torch.export import ExportedSynthesizer, export_synthesizer
from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples"))
import export_demo_for_torch as demo  # noqa: E402

GOLDEN_ATOL = {"mel": 1e-4, "wav": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def live_synth():
    return Synthesizer.from_checkpoint(demo.port_demo_config(), str(demo.OUT / "acoustic.npz"),
                                       str(demo.OUT / "vocoder.npz"), device="cpu")


@pytest.fixture(scope="module")
def artifact(live_synth, tmp_path_factory):
    out = tmp_path_factory.mktemp("exported")
    manifest = export_synthesizer(live_synth, out, max_batch=4, text_lens=(4, 8),
                                  devices=("cpu",))
    return out, manifest


@pytest.fixture(scope="module")
def exported_synth(artifact):
    return ExportedSynthesizer.load(artifact[0], device="cpu")


def _audiotype() -> str:
    meta = json.loads((demo.DEMO / "preprocessed" / "audiotype.json").read_text())
    return next(iter(meta))


def test_manifest_and_files(artifact):
    out, manifest = artifact
    assert manifest["format_version"] == 1
    assert sorted(manifest["buckets"]) == [[b, c] for b in (1, 2, 4) for c in (4, 8)]
    assert manifest["devices"] == ["cpu"] and manifest["torch_version"] == torch.__version__
    assert manifest["vocoder_model"] == "HiFi-GAN" and manifest["hop_length"] == 256
    assert (out / "config.json").exists() and (out / "symbols.json").exists()
    assert (out / "metadata" / "audiotype.json").exists()
    # one program holds the weights once for every bucket
    assert sorted(p.name for p in out.glob("*.pt2")) == ["fused_cpu.pt2"]


def test_exported_matches_live(live_synth, exported_synth):
    at = _audiotype()
    texts = ["パン", "ドンドン", "パパパ"]
    kwargs = dict(e_control=[1.0, 0.8, 1.2], d_control=[1.0, 1.3, 0.7])
    live = live_synth.synthesize_batch(texts, [at] * 3, **kwargs)
    exp = exported_synth.synthesize_batch(texts, [at] * 3, **kwargs)
    for r_live, r_exp in zip(live, exp):
        assert r_exp.mel_len == r_live.mel_len
        np.testing.assert_array_equal(r_exp.durations, r_live.durations)
        np.testing.assert_allclose(r_exp.wav, r_live.wav, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(r_exp.mel, r_live.mel, atol=1e-4, rtol=1e-4)


def test_exported_single_item_and_controls(live_synth, exported_synth):
    at = _audiotype()
    r_live = live_synth.synthesize("パンパン", at, d_control=1.4)
    r_exp = exported_synth.synthesize("パンパン", at, d_control=1.4)
    assert r_exp.mel_len == r_live.mel_len
    np.testing.assert_allclose(r_exp.wav, r_live.wav, atol=1e-5, rtol=1e-5)


def test_self_contained(artifact, tmp_path):
    """Loading reads nothing outside the artifact directory."""
    moved = tmp_path / "moved_artifact"
    shutil.copytree(artifact[0], moved)
    s = ExportedSynthesizer.load(moved, device="cpu")
    res = s.synthesize_batch(["パン"], [_audiotype()], return_mel=False)
    assert res[0].wav is not None and np.isfinite(res[0].wav).all()
    assert res[0].wav.shape[0] == res[0].mel_len * 256


def test_bucket_pad_up_and_limits(live_synth, exported_synth, artifact, tmp_path):
    at = _audiotype()
    texts = ["パンパンパ", "パン", "ドン"]
    live = live_synth.synthesize_batch(texts, [at] * 3, return_mel=False)
    exp = exported_synth.synthesize_batch(texts, [at] * 3, return_mel=False)
    for r_live, r_exp in zip(live, exp):
        assert r_exp.mel_len == r_live.mel_len
        np.testing.assert_allclose(r_exp.wav, r_live.wav, atol=1e-5, rtol=1e-5)
    # past the artifact's limits: clear errors, not shape crashes
    with pytest.raises(ValueError, match="re-export"):
        exported_synth.synthesize_batch(["パン"] * 5, [at] * 5, return_mel=False)
    with pytest.raises(ValueError, match="re-export"):
        exported_synth.synthesize("パンパンパンパンパ", at)
    # a signature the manifest does not list pads up to the smallest bucket
    # that covers it, with the live path's pad values
    cut = tmp_path / "cut"
    shutil.copytree(artifact[0], cut)
    manifest = json.loads((cut / "manifest.json").read_text())
    manifest["buckets"] = [[4, 8]]
    (cut / "manifest.json").write_text(json.dumps(manifest))
    padded = ExportedSynthesizer.load(cut, device="cpu")
    assert padded._pick_bucket(1, 4) == (4, 8)
    one = padded.synthesize_batch(["パンパン"], [at])[0]
    assert one.wav.shape == (one.mel_len * 256,) and np.isfinite(one.wav).all()


def test_max_text_len_property(exported_synth):
    assert exported_synth.max_text_len == 8
    assert exported_synth.max_batch == 4


def test_http_edge_enforces_artifact_text_limit(exported_synth):
    """A text longer than the artifact's largest text bucket gets a clean
    400 naming the limit at the HTTP edge, never reaching the worker where
    `_pick_bucket` would fail its whole micro-batch group."""
    import urllib.error
    import urllib.request

    from visual_onoma_to_wave_tpu_torch.serve import BatchingServer

    server = BatchingServer(exported_synth, port=0, max_batch=4, batch_window_ms=2.0)
    assert server.max_text_len == 8
    assert server.meta()["max_text_len"] == 8
    server.start()
    try:
        body = json.dumps({"text": "パ" * 9, "audiotype": _audiotype()}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/v1/synthesize",
                                     data=body, headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=120)
        assert ei.value.code == 400
        assert "1..8" in ei.value.read().decode()
        ok = json.dumps({"text": "パン", "audiotype": _audiotype()}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/v1/synthesize",
                                     data=ok, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert json.loads(resp.read())["mel_frames"] >= 1
    finally:
        server.stop()


def test_cli_export_device_validation(tmp_path):
    """--devices is validated before any checkpoint load."""
    from visual_onoma_to_wave_tpu_torch.cli import main as cli_main

    with pytest.raises(SystemExit, match="devices"):
        cli_main(["export", "nonexistent-config.json", "--acoustic", "none.npz", "--vocoder",
                  "none.npz", "--out", str(tmp_path), "--devices", "cpu, bogus"])


def test_cli_serve_exported_warns_on_ignored_args(artifact, capsys, monkeypatch):
    """cli serve --exported with a config and --vocoder warns that they are
    ignored and hands the artifact-capped limits to the server."""
    from visual_onoma_to_wave_tpu_torch import cli as cli_mod

    captured = {}

    class FakeServer:
        def __init__(self, synth, **kw):
            captured["synth"] = synth
            captured["kw"] = kw

        def serve_forever(self):
            captured["served"] = True

    monkeypatch.setattr("visual_onoma_to_wave_tpu_torch.serve.BatchingServer", FakeServer)
    cli_mod.main(["serve", str(demo.DEMO / "config.json"), "--exported", str(artifact[0]),
                  "--vocoder", "some/dir", "--max-batch", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "ignored" in out and "--vocoder" in out and "config" in out
    assert "requests capped at 8 characters" in out
    assert captured["kw"]["max_batch"] == 4
    assert isinstance(captured["synth"], ExportedSynthesizer)
    assert captured["served"]


def test_vocode_is_live_only(exported_synth):
    with pytest.raises(RuntimeError, match="live"):
        exported_synth.vocode(np.zeros((1, 64, 80), np.float32), [64])


def test_http_serving_from_artifact(exported_synth):
    import urllib.request

    from visual_onoma_to_wave_tpu_torch.serve import BatchingServer

    server = BatchingServer(exported_synth, port=0, max_batch=4, batch_window_ms=2.0)
    server.start()
    try:
        body = json.dumps({"text": "パン", "audiotype": _audiotype()}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/v1/synthesize",
                                     data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            out = json.loads(resp.read())
        assert out["mel_frames"] >= 1 and out["wav_b64"]
    finally:
        server.stop()


def _custom_ops(path: pathlib.Path) -> Counter:
    program = torch.export.load(path)
    return Counter(str(n.target) for n in program.graph.nodes if str(n.target).startswith("votw."))


def test_graph_calls_the_kernels_by_name(artifact, live_synth):
    """B1 once per FFT block (demo: 2 encoder + 2 decoder), B2 once per MRF
    stage of HiFi-GAN (4), nothing of them left as plain ops."""
    blocks = len(live_synth.model.encoder.layer_stack) + len(live_synth.model.decoder.layer_stack)
    assert blocks == 4
    assert _custom_ops(artifact[0] / "fused_cpu.pt2") == {
        "votw.attention_core.default": blocks, "votw.mrf_stage_fused.default": 4}


def test_vocos_artifact_calls_the_convnext_op(tmp_path):
    synth = Synthesizer.from_checkpoint(demo.port_demo_config("config_vocos.json"),
                                        str(demo.OUT / "acoustic.npz"),
                                        str(demo.OUT / "vocoder_vocos.npz"), device="cpu")
    export_synthesizer(synth, tmp_path, max_batch=2, text_lens=(4,), devices=("cpu",))
    ops = _custom_ops(tmp_path / "fused_cpu.pt2")
    assert ops["votw.convnext_block.default"] == len(synth.vocoder.blocks)
    assert ops["votw.attention_core.default"] == 4
    at = _audiotype()
    live = synth.synthesize_batch(["パン", "ドンドン"], [at] * 2)
    exp = ExportedSynthesizer.load(tmp_path, device="cpu").synthesize_batch(["パン", "ドンドン"],
                                                                           [at] * 2)
    for a, b in zip(live, exp):
        assert a.mel_len == b.mel_len
        np.testing.assert_allclose(b.wav, a.wav, atol=1e-5, rtol=1e-5)


def test_port_artifact_matches_the_jax_artifact(exported_synth, tmp_path):
    """The golden requests through JAX's `ExportedSynthesizer` (its artifact
    exported here from the demo checkpoint) and through the port's."""
    from visual_onoma_to_wave_tpu.export import ExportedSynthesizer as JExported
    from visual_onoma_to_wave_tpu.export import export_synthesizer as jexport
    from visual_onoma_to_wave_tpu.synthesis import Synthesizer as JSynthesizer

    jsynth = JSynthesizer.from_checkpoint(demo.demo_config(), acoustic=str(demo.DEMO / "acoustic"),
                                          vocoder=str(demo.DEMO / "vocoder"), mesh=None)
    jexport(jsynth, tmp_path, max_batch=4, text_lens=(8,), platforms=("cpu",))
    jexp = JExported.load(tmp_path)
    texts, types, rates, e, d = zip(*demo.GOLDEN_REQUESTS)
    kw = dict(width_rates=list(rates), e_control=list(e), d_control=list(d))
    want = jexp.synthesize_batch(list(texts), list(types), **kw)
    got = exported_synth.synthesize_batch(list(texts), list(types), **kw)
    for g, w in zip(got, want):
        assert g.mel_len == w.mel_len
        np.testing.assert_array_equal(g.durations, w.durations)
        np.testing.assert_allclose(g.mel, w.mel, rtol=0, atol=GOLDEN_ATOL["mel"])
        np.testing.assert_allclose(g.wav, w.wav, rtol=0, atol=GOLDEN_ATOL["wav"])


def test_cuda_artifact_needs_a_card(artifact, live_synth, tmp_path):
    """No artifact falls back to the CPU: a cuda program is traced on the
    card, loaded only on the card, and a CPU-only artifact refuses cuda."""
    if torch.cuda.is_available():
        pytest.skip("a card is here: the cuda artifact loads")
    with pytest.raises(RuntimeError, match="CUDA"):
        export_synthesizer(live_synth, tmp_path / "cuda", devices=("cuda",))
    with pytest.raises(ValueError, match="cpu"):
        ExportedSynthesizer.load(artifact[0], device="cuda")
    moved = tmp_path / "as_cuda"
    shutil.copytree(artifact[0], moved)
    manifest = json.loads((moved / "manifest.json").read_text())
    manifest["devices"] = ["cuda"]
    (moved / "manifest.json").write_text(json.dumps(manifest))
    (moved / "fused_cpu.pt2").rename(moved / "fused_cuda.pt2")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ExportedSynthesizer.load(moved, device="cuda")
    with pytest.raises(ValueError, match="devices must be"):
        export_synthesizer(live_synth, tmp_path / "bad", devices=("tpu",))
