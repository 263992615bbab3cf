"""The port's interactive demo server (`visual_onoma_to_wave_tpu_torch/
demo_server.py`) and its mel figure (`utils/plotting.py`) on the CPU.

The four tests of tests/test_demo_server.py run against the port's
`DemoServer`, over the tiny config of tests/test_trainer_synthesis.py with
the reference trainer's initial weights carried across by the bridge. Then
the port's `handle_synthesize` is held to the reference's on those weights:
durations and mel frames equal, the rendered strip's PNG byte-equal (the
renderers are bit-equal, tests/test_torch_host.py), the waveform within the
synthesis tests' 1e-5 (floats) and one 16-bit step (the wav payload), and
the mel figure an RGB PNG of the reference figure's pixel size.
"""
import base64
import dataclasses
import http.client
import io
import json
import wave

import numpy as np
import pytest

from test_trainer_synthesis import tiny_env  # noqa: F401 (fixture reuse)


@pytest.fixture(scope="module")
def pair(tiny_env):  # noqa: F811
    """(reference DemoServer, port DemoServer) over the same weights; the
    port's is started."""
    import jax
    import jax.numpy as jnp
    import torch

    from visual_onoma_to_wave_tpu.demo_server import DemoServer as JDemoServer
    from visual_onoma_to_wave_tpu.models.hifigan import HiFiGANGenerator as JHiFiGAN
    from visual_onoma_to_wave_tpu.synthesis import Synthesizer as JSynthesizer
    from visual_onoma_to_wave_tpu.training.trainer import Trainer
    from visual_onoma_to_wave_tpu_torch.bridge import hifigan_state_dict, vtts_state_dict
    from visual_onoma_to_wave_tpu_torch.config import DatasetMetadata, config_from_dict
    from visual_onoma_to_wave_tpu_torch.demo_server import DemoServer
    from visual_onoma_to_wave_tpu_torch.models import HiFiGANGenerator, VTTS
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    trainer = Trainer(tiny_env, use_mesh=False)
    jgen = JHiFiGAN(upsample_initial_channel=32)
    gp = jgen.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80), jnp.float32))
    symbol_map = trainer.train_ds.symbol_map
    jsynth = JSynthesizer(tiny_env, trainer.model, trainer.state, trainer.metadata, symbol_map,
                          gp, vocoder=jgen)

    cfg = config_from_dict(dataclasses.asdict(tiny_env))
    metadata = DatasetMetadata.load(cfg.path.preprocessed)
    model = VTTS.from_config(cfg, metadata, n_vocab=len(symbol_map))
    model.load_state_dict(vtts_state_dict(jax.tree.map(
        np.asarray, {"params": trainer.state.params,
                     "batch_stats": trainer.state.batch_stats})))
    gen = HiFiGANGenerator(upsample_initial_channel=32)
    gen.load_state_dict(hifigan_state_dict(jax.tree.map(np.asarray, gp)))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    srv = DemoServer(Synthesizer(cfg, model, metadata, symbol_map, gen, device="cpu"), port=0)
    srv.start()
    yield JDemoServer(jsynth, port=0), srv
    srv.stop()
    torch.set_num_threads(n_threads)
    trainer.ckpt.close()


@pytest.fixture(scope="module")
def server(pair):
    return pair[1]


def _request(srv, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
    headers = {"Content-Type": "application/json"} if body else {}
    conn.request(method, path, json.dumps(body) if body is not None else None, headers)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _pcm(wav_b64: str) -> np.ndarray:
    with wave.open(io.BytesIO(base64.b64decode(wav_b64)), "rb") as w:
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)


def test_page_and_meta(server):
    status, page = _request(server, "GET", "/")
    assert status == 200
    html = page.decode()
    assert "keypad" in html and "width" in html.lower()
    status, meta = _request(server, "GET", "/api/meta")
    assert status == 200
    m = json.loads(meta)
    assert m["audiotypes"] == ["drum"]
    assert m["has_vocoder"] is True
    assert m["sampling_rate"] == 22050


def test_synthesize_endpoint(server):
    status, body = _request(server, "POST", "/api/synthesize", {
        "text": "パンパン", "audiotype": "drum",
        "width_rates": [1.0, 0.5, 1.5, 0.5],
        "e_control": 1.0, "d_control": 1.0,
    })
    assert status == 200, body[:500]
    r = json.loads(body)
    assert len(r["durations"]) == 4
    assert r["mel_frames"] >= 1
    assert r["image_b64"] and r["mel_b64"] and r["wav_b64"]
    # the wav payload is a decodable 16-bit mono file of the right length
    with wave.open(io.BytesIO(base64.b64decode(r["wav_b64"])), "rb") as w:
        assert w.getframerate() == 22050
        assert w.getnchannels() == 1
        assert w.getnframes() == r["mel_frames"] * 256
    from PIL import Image
    img = Image.open(io.BytesIO(base64.b64decode(r["image_b64"])))
    assert img.height == 24

    # the width-rate control is live: the rendered strip changes
    status2, body2 = _request(server, "POST", "/api/synthesize", {
        "text": "パンパン", "audiotype": "drum",
        "width_rates": [3.0, 3.0, 3.0, 3.0],
    })
    r2 = json.loads(body2)
    a = np.asarray(Image.open(io.BytesIO(base64.b64decode(r["image_b64"]))))
    b = np.asarray(Image.open(io.BytesIO(base64.b64decode(r2["image_b64"]))))
    assert a.shape == b.shape and not np.array_equal(a, b)


def test_synthesize_errors(server):
    status, body = _request(server, "POST", "/api/synthesize", {"text": ""})
    assert status == 400
    status, _ = _request(server, "GET", "/nope")
    assert status == 404


def test_request_limits(server):
    from visual_onoma_to_wave_tpu_torch.demo_server import MAX_TEXT_LEN

    # oversized body -> 413 without being read
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=120)
    conn.putrequest("POST", "/api/synthesize")
    conn.putheader("Content-Type", "application/json")
    conn.putheader("Content-Length", str(16 << 20))
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 413
    conn.close()

    # over-long text -> 400 with the cap in the message
    status, body = _request(server, "POST", "/api/synthesize",
                            {"text": "ア" * (MAX_TEXT_LEN + 1), "audiotype": 0})
    assert status == 400 and b"too long" in body
    # non-string text -> 400, not a crash
    status, _ = _request(server, "POST", "/api/synthesize", {"text": 123, "audiotype": 0})
    assert status == 400


def test_limits_and_page_equal_the_reference():
    import visual_onoma_to_wave_tpu.demo_server as ref
    import visual_onoma_to_wave_tpu_torch.demo_server as port

    assert (port.MAX_BODY, port.MAX_TEXT_LEN, port.KEYPAD_ROWS, port.PAGE) == (
        ref.MAX_BODY, ref.MAX_TEXT_LEN, ref.KEYPAD_ROWS, ref.PAGE)


@pytest.mark.parametrize("req", [
    {"text": "パンパン", "audiotype": "drum", "width_rates": [1.0, 0.5, 1.5, 0.5]},
    {"text": "パン", "audiotype": 0, "width_rates": [0.01, 50.0], "e_control": 1.3,
     "d_control": 4.0},                          # rates clamped to [0.05, 8]
    {"text": "パン", "audiotype": "drum", "d_control": 0.2},    # no frame: no audio
    {"text": "パンパ", "audiotype": "drum", "width_rates": [1.0]},   # wrong count: ignored
])
def test_handle_synthesize_matches_the_reference(pair, req):
    """The port's handler against the reference's on the same weights (an
    item whose durations all round to 0 has no audio on either side)."""
    from PIL import Image

    from visual_onoma_to_wave_tpu_torch.utils.plotting import FIG_WIDTH, PANEL_HEIGHT

    ref, port = (srv.handle_synthesize(dict(req)) for srv in pair)
    assert port["durations"] == ref["durations"]
    assert port["mel_frames"] == ref["mel_frames"]
    assert port["seconds"] == ref["seconds"]
    assert port["image_b64"] == ref["image_b64"]
    assert (port["wav_b64"] is None) == (ref["wav_b64"] is None)
    if ref["wav_b64"] is not None:
        assert np.abs(_pcm(port["wav_b64"]) - _pcm(ref["wav_b64"])).max() <= 1
    fig = Image.open(io.BytesIO(base64.b64decode(port["mel_b64"])))
    assert fig.format == "PNG" and fig.mode == "RGB"
    assert fig.size == (FIG_WIDTH, PANEL_HEIGHT)

    rates = req.get("width_rates")
    rates = rates if rates is not None and len(rates) == len(req["text"]) else None
    kw = dict(width_rates=None if rates is None else [min(max(r, 0.05), 8.0) for r in rates],
              e_control=req.get("e_control", 1.0), d_control=req.get("d_control", 1.0))
    want = pair[0].synth.synthesize(req["text"], req["audiotype"], **kw)
    got = pair[1].synth.synthesize(req["text"], req["audiotype"], **kw)
    if want.wav is not None:
        np.testing.assert_allclose(got.wav, np.asarray(want.wav), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.mel, np.asarray(want.mel), rtol=0, atol=1e-4)


def test_viridis_matches_matplotlib():
    """The figure's colours: matplotlib's viridis (the reference figure's
    default map) within 1/255 at its anchors and 3/255 between them (256
    entries against 9 anchors interpolated)."""
    import matplotlib

    from visual_onoma_to_wave_tpu_torch.utils.plotting import viridis

    x = np.linspace(0.0, 1.0, 257)
    want = matplotlib.colormaps["viridis"](x)[:, :3] * 255.0
    err = np.abs(viridis(x).astype(np.float64) - want)
    assert err[::32].max() <= 1.0 and err.max() <= 3.0


def test_plot_mel_layout():
    """Panels stacked at the reference figure's pixel size, each under its
    title; low bins at the bottom; a constant mel does not divide by zero."""
    from PIL import Image

    from visual_onoma_to_wave_tpu_torch.utils import plotting

    mel = np.tile(np.linspace(-11.0, 2.0, 80), (120, 1))          # (T, n_mels): rises with bin
    fig = plotting.plot_mel([(mel, "a"), (np.zeros((10, 80)), "b")])
    assert fig.mode == "RGB"
    assert fig.size == (plotting.FIG_WIDTH, 2 * plotting.PANEL_HEIGHT)
    px = np.asarray(fig)
    top, bottom = plotting.TITLE_HEIGHT, plotting.PANEL_HEIGHT - 1
    # the highest bin is viridis(1) across the panel, the lowest viridis(0)
    assert (px[top] == plotting.viridis(np.array(1.0))).all()
    assert (px[bottom] == plotting.viridis(np.array(0.0))).all()
    # the constant mel's panel is viridis(0) throughout, under its title
    assert (px[plotting.PANEL_HEIGHT + top:] == plotting.viridis(np.array(0.0))).all()
    for y0 in (0, plotting.PANEL_HEIGHT):
        title = px[y0:y0 + plotting.TITLE_HEIGHT]
        assert (title < 128).all(axis=-1).any() and (title == 255).all(axis=-1).any()
    png = Image.open(io.BytesIO(plotting.png_bytes(fig)))
    assert png.format == "PNG" and png.size == fig.size


def test_cli_demo_serves_the_trainers_checkpoint(tiny_env, tmp_path, monkeypatch):  # noqa: F811
    """`cli demo` without --acoustic serves the acoustic weights of a
    checkpoint that the port's trainer wrote under path.ckpt: the latest
    by default and with --restore-step -1, the named step otherwise; a step
    with no checkpoint exits. Each served instance answers one request."""
    import torch

    from visual_onoma_to_wave_tpu_torch import cli
    from visual_onoma_to_wave_tpu_torch.config import config_from_dict
    from visual_onoma_to_wave_tpu_torch.demo_server import DemoServer
    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer

    data = dataclasses.asdict(tiny_env)
    data["path"].update(ckpt=str(tmp_path / "ckpt"), log=str(tmp_path / "log"),
                        result=str(tmp_path / "result"))
    config = tmp_path / "config.json"
    config.write_text(json.dumps(data))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        trainer = Trainer(config_from_dict(data), device="cpu", loader_workers=0)
        weights = {}
        for step in (1, 2):
            trainer.train(max_steps=step)
            weights[step] = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
        assert trainer.ckpt.all_steps() == [1, 2]

        served = []

        def serve_forever(self):
            self.start()
            try:
                served.append((self.synth.model.state_dict(), _request(
                    self, "POST", "/api/synthesize", {"text": "パンパン", "audiotype": "drum"})))
            finally:
                self.stop()

        monkeypatch.setattr(DemoServer, "serve_forever", serve_forever)
        demo = ["demo", str(config), "--port", "0", "--device", "cpu"]
        for extra, step in (([], 2), (["--restore-step", "-1"], 2),
                            (["--restore-step", "1"], 1)):
            cli.main(demo + extra)
            state, (status, body) = served.pop()
            assert status == 200, body[:500]
            assert json.loads(body)["mel_frames"] >= 1
            assert state.keys() == weights[step].keys()
            assert all(torch.equal(state[k], weights[step][k]) for k in state), extra
        with pytest.raises(SystemExit, match="no checkpoint at step 3"):
            cli.main(demo + ["--restore-step", "3"])
        assert not served
    finally:
        torch.set_num_threads(n_threads)
