"""The port's served path against the committed JAX golden (demo checkpoint).

examples/checkpoints/demo/torch/golden.npz holds four requests served by the
JAX `Synthesizer` (its exact padded inputs and its outputs). The port's
`Synthesizer`, run on the CPU over the same requests, must render the same
inputs, give exactly the same durations and mel lengths, and agree on the
mel and waveform to 1e-4 / 1e-5 absolute (float32 on both sides; mel
values reach ~16, waveform samples stay in [-1, 1]).
"""
from __future__ import annotations

import base64
import http.client
import io
import json
import pathlib
import sys
import wave

import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer, make_fused_infer, resolve_device

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples"))
import export_demo_for_torch as export  # noqa: E402

INPUTS = ("audiotypes", "texts", "src_lens", "image_cells")
ATOL = {"postnet_mel": 1e-4, "wav": 1e-5}


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(export.OUT / "golden.npz"))


@pytest.fixture(scope="module")
def synth():
    return Synthesizer.from_checkpoint(export.port_demo_config(),
                                       str(export.OUT / "acoustic.npz"),
                                       str(export.OUT / "vocoder.npz"), device="cpu")


def test_synthesizer_reproduces_golden(synth, golden):
    seen = {}
    run = synth._run

    def spy(batch, e_ctl, d_ctl):
        seen.update(batch, e_control=e_ctl, d_control=d_ctl)
        out = run(batch, e_ctl, d_ctl)
        seen.update(out)
        return out

    synth._run = spy
    texts, types, rates, e, d = zip(*export.GOLDEN_REQUESTS)
    try:
        results = synth.synthesize_batch(list(texts), list(types), width_rates=list(rates),
                                         e_control=list(e), d_control=list(d))
    finally:
        del synth._run
    for k in export.GOLDEN_INPUTS + ("duration_rounded", "mel_lens"):
        np.testing.assert_array_equal(seen[k], golden[k], err_msg=k)
    for k, tol in ATOL.items():
        np.testing.assert_allclose(seen[k], golden[k], rtol=0, atol=tol, err_msg=k)
    for i, r in enumerate(results):
        assert r.mel_len == golden["mel_lens"][i]
        assert r.wav.shape == (r.mel_len * 256,) and np.isfinite(r.wav).all()


def test_fused_infer_on_golden_inputs(synth, golden):
    """The serving hot path alone, fed the JAX Synthesizer's exact inputs."""
    fused = make_fused_infer(synth.model, synth.vocoder)
    out = fused({k: torch.from_numpy(golden[k]) for k in INPUTS},
                e_control=torch.from_numpy(golden["e_control"]),
                d_control=torch.from_numpy(golden["d_control"]))
    np.testing.assert_array_equal(out["duration_rounded"].numpy(), golden["duration_rounded"])
    np.testing.assert_array_equal(out["mel_lens"].numpy(), golden["mel_lens"])
    for k, tol in ATOL.items():
        np.testing.assert_allclose(out[k].numpy(), golden[k], rtol=0, atol=tol, err_msg=k)


def test_golden_still_matches_the_jax_package(golden):
    """golden.npz is what the JAX package serves now (same host class: XLA
    CPU, float32; 1e-5 / 1e-6 absolute for a different CPU's vector code)."""
    now = export.golden()
    assert sorted(now) == sorted(golden)
    for k in golden:
        if golden[k].dtype.kind == "f" and k not in export.GOLDEN_INPUTS:
            tol = 1e-5 if k == "postnet_mel" else 1e-6
            np.testing.assert_allclose(now[k], golden[k], rtol=0, atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(now[k], golden[k], err_msg=k)


def test_batching_server_serves_the_port(synth):
    from visual_onoma_to_wave_tpu_torch.serve import BatchingServer

    srv = BatchingServer(synth, port=0, max_batch=4, batch_window_ms=10.0)
    srv.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        conn.request("POST", "/v1/synthesize", json.dumps({"text": "パンパン", "audiotype": "drum"}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        status, body = resp.status, json.loads(resp.read())
        conn.close()
    finally:
        srv.stop()
    assert status == 200, body
    assert len(body["durations"]) == 4
    assert body["mel_frames"] == min(sum(body["durations"]), 512)
    with wave.open(io.BytesIO(base64.b64decode(body["wav_b64"])), "rb") as w:
        assert w.getnframes() == body["mel_frames"] * 256
        assert w.getframerate() == body["sample_rate"] == 22050


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the no-CUDA error path cannot be reached")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
