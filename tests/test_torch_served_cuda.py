"""The port's `Synthesizer` on the card, served by the port's own HTTP server.

The demo checkpoint (`examples/checkpoints/demo/torch/*.npz`), with its
HiFi-GAN (config.json), its Vocos (config_vocos.json) or its iSTFTNet-mel
(config_istftnet.json), is loaded with `device="cuda"` through the port's
config loader and put behind `visual_onoma_to_wave_tpu_torch.serve.
BatchingServer`. Four concurrent `/v1/synthesize` requests must each answer
HTTP 200 with the expected frame count and nonzero audio, every waveform the
port hands the server must be finite, and the path's kernels must have
launched (attention; for Vocos also the ConvNeXt block; for iSTFTNet-mel the
fused MRF stage, once per batch). Imports nothing of JAX or of the JAX
package. Needs an NVIDIA GPU; on the card:

    python -m pytest tests/test_torch_served_cuda.py -q
"""
from __future__ import annotations

import base64
import http.client
import io
import json
import pathlib
import threading
import wave

import numpy as np
import pytest
import torch

DEMO = pathlib.Path(__file__).resolve().parents[1] / "examples" / "checkpoints" / "demo"
REQUESTS = [{"text": "バウバウ", "audiotype": "bell"},
            {"text": "チパチパチパ", "audiotype": "drum"},
            {"text": "パシウドパシウド", "audiotype": "bell", "e_control": 1.2},
            {"text": "シトパリ", "audiotype": "drum", "d_control": 1.5}]


@pytest.mark.gpu
@pytest.mark.parametrize("config,vocoder", [("config.json", "vocoder.npz"),
                                            ("config_vocos.json", "vocoder_vocos.npz"),
                                            ("config_istftnet.json", "vocoder_istftnet_mel.npz")],
                         ids=["hifigan", "vocos", "istftnet-mel"])
def test_batching_server_serves_the_port_on_the_card(config, vocoder):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's Synthesizer runs on the card here")
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.ops.attention import attention_core
    from visual_onoma_to_wave_tpu_torch.ops.convnext import convnext_block
    from visual_onoma_to_wave_tpu_torch.ops.mrf import mrf_stage_fused
    from visual_onoma_to_wave_tpu_torch.serve import BatchingServer
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    cfg = load_config(str(DEMO / config))
    cfg = cfg.replace(path=cfg.path.__class__(
        corpus="", formatted="", preprocessed=str(DEMO / "preprocessed"), font="",
        ckpt=str(DEMO / "preprocessed"), log="", result=""))
    synth = Synthesizer.from_checkpoint(cfg, str(DEMO / "torch" / "acoustic.npz"),
                                        str(DEMO / "torch" / vocoder), device="cuda")
    served = []   # the PCM in the HTTP answers cannot show NaN: check the floats
    batch_fn = synth.synthesize_batch

    def checked_batch(*args, **kwargs):
        results = batch_fn(*args, **kwargs)
        served.extend(bool(np.isfinite(r.wav).all()) for r in results)
        return results

    synth.synthesize_batch = checked_batch
    srv = BatchingServer(synth, port=0, max_batch=8, batch_window_ms=50.0)
    srv.warmup()
    srv.start()
    answers = [None] * len(REQUESTS)

    def post(i):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        try:
            conn.request("POST", "/v1/synthesize", json.dumps(REQUESTS[i]),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            answers[i] = (resp.status, json.loads(resp.read()))
        finally:
            conn.close()

    launches = attention_core.launches, convnext_block.launches, mrf_stage_fused.launches
    srv.reset_stats()
    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(REQUESTS))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        batches = srv.snapshot_stats()["batches"]
    finally:
        srv.stop()
    # the card's kernels served them
    assert attention_core.launches > launches[0]
    if cfg.model.vocoder_model == "Vocos":
        assert convnext_block.launches > launches[1]
    # one MRF launch per stage: iSTFTNet-mel's one, the demo HiFi-GAN's four
    mrf = {"iSTFTNet-mel": 1, "HiFi-GAN": 4}.get(cfg.model.vocoder_model, 0)
    assert mrf_stage_fused.launches - launches[2] == mrf * batches
    for req, ans in zip(REQUESTS, answers):
        assert ans is not None and ans[0] == 200, (req, ans)
        r = ans[1]
        with wave.open(io.BytesIO(base64.b64decode(r["wav_b64"])), "rb") as w:
            n, sw = w.getnframes(), w.getsampwidth()
            pcm = np.frombuffer(w.readframes(n), dtype=f"<i{sw}")
        expect = min(sum(r["durations"]), cfg.train.max_mel_len)
        assert len(r["durations"]) == len(req["text"]), (req, r["durations"])
        assert r["mel_frames"] == max(expect, 1), (req, r["mel_frames"], r["durations"])
        assert n == r["mel_frames"] * cfg.audio.stft.hop_length and pcm.any(), (req, n)
    assert served and all(served), served
