"""The HTTP behaviours of tests/test_serve.py against the port's server
(`visual_onoma_to_wave_tpu_torch/serve.py::BatchingServer`) and `Synthesizer`
on the CPU.

The tiny config of tests/test_trainer_synthesis.py (hidden 32, one encoder
and one decoder layer, a drum-only corpus of 8 clips) through the port's own
modules, with random weights from `torch.manual_seed(0)` and a HiFi-GAN V1
of 32 initial channels. One test per behaviour of the reference's file, under
the same name; where a reference test patches `Synthesizer.synthesize_batch`,
these patch the port's. Watchdog and deadline limits are 1 s, as there.
"""
import base64
import dataclasses
import http.client
import io
import json
import threading
import wave

import pytest
import torch

from test_trainer_synthesis import tiny_env  # noqa: F401 (fixture reuse)


def port_synthesizer(jax_config, seed: int = 0, vocoder_channels: int = 32):
    """The port's `Synthesizer` on the CPU for the reference's config
    `jax_config` (the same preprocessed directory), its acoustic model and
    HiFi-GAN V1 drawn from `torch.manual_seed(seed)`."""
    from visual_onoma_to_wave_tpu_torch.config import DatasetMetadata, config_from_dict
    from visual_onoma_to_wave_tpu_torch.data.symbols import build_symbol_map
    from visual_onoma_to_wave_tpu_torch.models import HiFiGANGenerator, VTTS
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    cfg = config_from_dict(dataclasses.asdict(jax_config))
    metadata = DatasetMetadata.load(cfg.path.preprocessed)
    symbol_map = build_symbol_map(cfg.path.preprocessed)
    torch.manual_seed(seed)
    model = VTTS.from_config(cfg, metadata, n_vocab=len(symbol_map))
    gen = HiFiGANGenerator(upsample_initial_channel=vocoder_channels)
    return Synthesizer(cfg, model, metadata, symbol_map, gen, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Tiny tensors beside the other test workers: more intra-op threads
    only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth(tiny_env):  # noqa: F811
    return port_synthesizer(tiny_env)


@pytest.fixture(scope="module")
def server(synth):
    from visual_onoma_to_wave_tpu_torch.serve import BatchingServer

    srv = BatchingServer(synth, port=0, max_batch=8, batch_window_ms=200.0)
    srv.start()
    yield srv
    srv.stop()


def _request(srv, method, path, body=None, timeout=300):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=timeout)
    conn.request(method, path,
                 json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"} if body else {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, json.loads(data)


def test_health_and_meta(server):
    status, h = _request(server, "GET", "/healthz")
    assert status == 200 and h["ok"] is True
    status, m = _request(server, "GET", "/v1/meta")
    assert status == 200
    assert m["audiotypes"] == ["drum"]
    assert m["sampling_rate"] == 22050 and m["max_batch"] == 8
    # clients can discover the validation limits
    assert m["max_text_len"] >= 1 and m["max_queue"] >= 1
    assert m["width_rate_range"][0] < 1.0 < m["width_rate_range"][1]
    assert m["control_range"][0] < 1.0 < m["control_range"][1]


def test_single_request_roundtrip(server):
    status, r = _request(server, "POST", "/v1/synthesize",
                         {"text": "パン", "audiotype": "drum"})
    assert status == 200, r
    assert len(r["durations"]) == 2 and r["mel_frames"] >= 1
    with wave.open(io.BytesIO(base64.b64decode(r["wav_b64"])), "rb") as w:
        assert w.getframerate() == r["sample_rate"] == 22050
        assert w.getnframes() == r["mel_frames"] * 256
    assert r["seconds"] == pytest.approx(r["mel_frames"] * 256 / 22050)


def test_concurrent_requests_are_microbatched(server):
    b0 = _request(server, "GET", "/v1/stats")[1]["batches"]
    results = [None] * 6

    def fire(i):
        results[i] = _request(server, "POST", "/v1/synthesize",
                              {"text": "ドンドン", "audiotype": "drum",
                               "width_rates": [1.0, 0.5 + 0.1 * i, 1.0, 1.0]})

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r[0] == 200 for r in results), results
    _, stats = _request(server, "GET", "/v1/stats")
    batches = stats["batches"] - b0
    # 6 concurrent requests within a 200ms window must share batches
    assert 1 <= batches < 6
    assert stats["mean_batch_size"] > 1.0
    assert "latency_ms_p50" in stats


def test_batch_endpoint(server):
    status, out = _request(server, "POST", "/v1/batch", {"items": [
        {"text": "パン", "audiotype": "drum"},
        {"text": "ドドド", "audiotype": 0, "width_rates": [1.0, 1.0, 2.0]},
    ]})
    assert status == 200, out
    assert len(out["items"]) == 2
    assert len(out["items"][0]["durations"]) == 2
    assert len(out["items"][1]["durations"]) == 3


def test_validation_errors(server):
    assert _request(server, "POST", "/v1/synthesize", {"text": ""})[0] == 400
    assert _request(server, "POST", "/v1/synthesize",
                    {"text": "パ", "audiotype": "nope"})[0] == 400
    assert _request(server, "POST", "/v1/synthesize",
                    {"text": "パン", "audiotype": "drum",
                     "width_rates": [1.0]})[0] == 400
    assert _request(server, "POST", "/v1/batch", {"items": []})[0] == 400
    assert _request(server, "POST", "/nope", {})[0] == 404


def test_type_malformed_requests_get_400(server):
    """Wrong TYPES (not just wrong values) must be a 400 JSON response, not
    an uncaught exception in the handler thread (which closes the
    connection with no HTTP response)."""
    bad = [
        {"text": 5},                                        # non-string text
        {"text": "パ", "width_rates": 3},                   # non-list rates
        {"text": "パ", "width_rates": ["a"]},               # non-numeric rate
        {"text": "パ", "width_rates": [True]},              # bool rate
        {"text": "パ", "width_rates": [1e6]},               # resource DoS:
        #   fontsize * rate is a PIL image width (measured GBs at 1e6)
        {"text": "パ", "e_control": 10 ** 400},             # huge JSON int:
        #   float() overflows, np.isfinite raises — must still be a 400
        {"text": "パ", "width_rates": [10 ** 400]},
        {"text": "パ", "d_control": 1000.0},                # out of range
        {"text": "パ{ン"},                                  # brace in text
        {"text": "パ\nン"},                                 # newline in text
        {"text": "パ", "audiotype": 99},                    # id out of range
        {"text": "パ", "audiotype": [1]},                   # wrong type
        {"text": "パ", "e_control": True},                  # bool control
    ]
    for req in bad:
        status, out = _request(server, "POST", "/v1/synthesize", req)
        assert status == 400 and "error" in out, req
    assert _request(server, "POST", "/v1/batch", {"items": "ab"})[0] == 400
    assert _request(server, "POST", "/v1/batch", {"items": ["x"]})[0] == 400
    # attacker-sized Content-Length must be refused before buffering
    import http.client as hc
    conn = hc.HTTPConnection("127.0.0.1", server.port, timeout=300)
    conn.putrequest("POST", "/v1/synthesize")
    conn.putheader("Content-Type", "application/json")
    conn.putheader("Content-Length", str(10 ** 10))
    conn.endheaders()
    resp = conn.getresponse()
    assert resp.status == 413
    resp.read()
    conn.close()
    # non-object JSON body
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=300)
    conn.request("POST", "/v1/synthesize", json.dumps([1, 2]),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 400
    resp.read()
    conn.close()
    # the server still serves afterwards
    status, r = _request(server, "POST", "/v1/synthesize",
                         {"text": "パ", "audiotype": "drum"})
    assert status == 200 and r["mel_frames"] >= 1


def test_non_numeric_controls_rejected_not_wedged(server):
    """A malformed control must be a 400 at validation, never reach the
    singleton worker (where it would kill it and wedge every later
    request)."""
    status, out = _request(server, "POST", "/v1/synthesize",
                           {"text": "パ", "audiotype": "drum",
                            "d_control": "fast"})
    assert status == 400 and "d_control" in out["error"]
    status, _ = _request(server, "POST", "/v1/synthesize",
                         {"text": "パ", "audiotype": "drum",
                          "e_control": float("nan")})
    assert status == 400
    # the server still serves afterwards
    status, r = _request(server, "POST", "/v1/synthesize",
                         {"text": "パ", "audiotype": "drum"})
    assert status == 200 and r["mel_frames"] >= 1


def test_reset_stats(server):
    _request(server, "POST", "/v1/synthesize",
             {"text": "パ", "audiotype": "drum"})
    assert _request(server, "GET", "/v1/stats")[1]["requests"] > 0
    server.reset_stats()
    s = _request(server, "GET", "/v1/stats")[1]
    assert s["requests"] == 0 and s["batches"] == 0
    assert "latency_ms_p50" not in s


def test_served_requests_carry_their_ids_in_spans(server):
    """Under a profiler session each request's `serve.queue_wait` and
    `serve.request` spans carry its id, the same in both; each group has its
    `serve.collect` and `serve.encode` spans, and its synthesis its
    `synth.batch` with the group's rows counted."""
    from torch.profiler import ProfilerActivity, profile

    from visual_onoma_to_wave_tpu_torch import tracing

    n, codes = 4, []

    def one(i):
        codes.append(_request(server, "POST", "/v1/synthesize",
                              {"text": "パンパ"[:1 + i % 3], "audiotype": "drum"})[0])

    with profile(activities=[ProfilerActivity.CPU]):
        threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and codes == [200] * n
    spans = tracing.spans()
    waits = [s for s in spans if s.name == "serve.queue_wait"]
    done = [s for s in spans if s.name == "serve.request"]
    assert len({s.req for s in waits}) == n and len(done) == n
    assert sorted(s.req for s in waits) == sorted(s.req for s in done)
    for w in waits:
        d = next(s for s in done if s.req == w.req)
        assert d.start == w.start <= w.end <= d.end
    names = {s.name for s in spans}
    assert {"serve.collect", "serve.encode", "synth.batch"} <= names
    assert sum(s.counts.get("synth.rows", 0) for s in spans if s.counts) == n


def test_stats_report_synthesis_counts(server):
    """/v1/stats's "synth": the recorder's cumulative counts, which a
    request moves by its own row, characters, frames and copies."""
    keys = {"rows", "rows_padded", "chars", "chars_padded", "frames", "frames_vocoded",
            "h2d_bytes", "d2h_bytes", "glyph_hits", "glyph_misses", "amp_sites",
            "amp_sites_plain"}
    before = _request(server, "GET", "/v1/stats")[1]["synth"]
    status, r = _request(server, "POST", "/v1/synthesize", {"text": "パン", "audiotype": "drum"})
    assert status == 200
    after = _request(server, "GET", "/v1/stats")[1]["synth"]
    assert set(before) == set(after) == keys
    d = {k: after[k] - before[k] for k in keys}
    assert d["rows"] == d["rows_padded"] == 1 and d["frames"] == r["mel_frames"]
    assert d["chars"] == 2 and d["chars_padded"] == 4      # padded to the 4-character bucket
    assert d["glyph_hits"] + d["glyph_misses"] == 2        # one cell lookup a character
    assert d["frames_vocoded"] >= d["frames"] and d["d2h_bytes"] > 0 and d["h2d_bytes"] > 0
    assert d["amp_sites"] == d["amp_sites_plain"] == 0     # HiFi-GAN has no AMP sites
    server.reset_stats()     # the server's counters only; the recorder's are per process
    assert _request(server, "GET", "/v1/stats")[1]["synth"] == after


def test_distinct_controls_share_a_batch(server):
    """Controls are per-item traced inputs: requests with different
    d_control coalesce into ONE device batch (no grouping, no starvation)
    and each is served with its own control value."""
    results = [None] * 2
    before = _request(server, "GET", "/v1/stats")[1]["batches"]

    def fire(i, d):
        results[i] = _request(server, "POST", "/v1/synthesize",
                              {"text": "パンパン", "audiotype": "drum",
                               "d_control": d})

    threads = [threading.Thread(target=fire, args=(0, 1.0)),
               threading.Thread(target=fire, args=(1, 1.5))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results[0][0] == 200 and results[1][0] == 200
    # longer duration control should never shorten the clip
    assert results[1][1]["mel_frames"] >= results[0][1]["mel_frames"]
    # both went through at most 2 batches (1 when the window caught both);
    # the old design forced them into separate groups with re-queueing
    after = _request(server, "GET", "/v1/stats")[1]["batches"]
    assert after - before <= 2


def test_queue_backpressure_503():
    """Past max_queue waiting requests the server answers 503 immediately
    instead of building unbounded latency."""
    from visual_onoma_to_wave_tpu_torch.serve import BatchingServer, _Pending

    class _NoSynth:  # submit() path only touches validation + the queue
        class metadata:
            audiotype_map = {"drum": 0}

        class config:
            class audio:
                sampling_rate = 22050

                class stft:
                    hop_length = 256
        use_image = True
        vocoder_params = None

    srv = BatchingServer(_NoSynth(), port=0, max_queue=2)
    # do NOT start the worker: fill the queue directly
    srv._q.put_nowait(_Pending({"text": "パ"}, 30.0))
    srv._q.put_nowait(_Pending({"text": "パ"}, 30.0))
    status, out = srv.submit({"text": "パ", "audiotype": "drum"})
    assert status == 503 and "overloaded" in out["error"]
    status, out = srv.run_batch([{"text": "パ", "audiotype": "drum"}])
    assert status == 503
    srv._drain_queue()
    srv.httpd.server_close()


def test_stop_fails_queued_requests_instead_of_hanging(synth):
    """stop() must release queued waiters with an error — a client whose
    request is still in the queue can never be left blocking forever."""
    from visual_onoma_to_wave_tpu_torch.serve import BatchingServer

    srv = BatchingServer(synth, port=0, max_batch=4, batch_window_ms=50.0)
    srv.start()
    results = {}

    def fire(i):
        try:
            results[i] = _request(srv, "POST", "/v1/synthesize",
                                  {"text": "パ", "audiotype": "drum"})
        except Exception as e:  # connection refused/reset around shutdown
            results[i] = (599, {"error": str(e)})

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    srv.stop()
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive(), "request hung across server stop"
    # every request either completed (in-flight batch), got a 5xx error,
    # or saw the connection close — none blocked forever
    assert len(results) == 3
    for status, _ in results.values():
        assert status in (200, 500, 503, 599)


def test_poisoned_request_isolated_from_batch(server, monkeypatch):
    """A request that fails inside the device call must not fail innocent
    requests micro-batched with it: the worker retries items individually."""
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    real = Synthesizer.synthesize_batch

    def poisoned(self, texts, audiotypes, **kw):
        if any(t == "ドド" for t in texts) and len(texts) > 1:
            raise RuntimeError("injected batch failure")
        if texts == ["ドド"]:
            raise RuntimeError("injected item failure")
        return real(self, texts, audiotypes, **kw)

    monkeypatch.setattr(Synthesizer, "synthesize_batch", poisoned)
    results = {}

    def fire(key, text):
        results[key] = _request(server, "POST", "/v1/synthesize",
                                {"text": text, "audiotype": "drum"})

    threads = [threading.Thread(target=fire, args=("bad", "ドド")),
               threading.Thread(target=fire, args=("good1", "パン")),
               threading.Thread(target=fire, args=("good2", "パンパ"))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # the innocent requests succeed even when batched with the poisoned one
    assert results["good1"][0] == 200 and results["good2"][0] == 200
    assert results["bad"][0] == 500
    # details are logged server-side only; clients get a generic message
    # (exception text can carry internal shapes/paths)
    assert results["bad"][1]["error"] == "synthesis failed"
    assert "injected" not in results["bad"][1]["error"]


def test_meta_exposes_deadline_limits(server):
    m = _request(server, "GET", "/v1/meta")[1]
    assert m["request_timeout_s"] > 0
    assert 1 <= m["batch_queue_reserve"] < m["max_queue"]


def test_queued_past_deadline_gets_504(server, monkeypatch):
    """A request whose deadline passes while still queued is answered 504
    and is NEVER sent to the device."""
    import threading as th
    import time

    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    real = Synthesizer.synthesize_batch
    gate = th.Event()
    calls = []

    def gated(self, texts, audiotypes, **kw):
        calls.append(list(texts))
        gate.wait(timeout=60)
        return real(self, texts, audiotypes, **kw)

    monkeypatch.setattr(Synthesizer, "synthesize_batch", gated)
    monkeypatch.setattr(server, "timeout_s", 1.0)
    results = {}

    def fire(key, text):
        results[key] = _request(server, "POST", "/v1/synthesize",
                                {"text": text, "audiotype": "drum"})

    # occupy EVERY pipeline slot with gated in-flight device calls...
    occupants = []
    for i in range(server.pipeline_depth):
        t = th.Thread(target=fire, args=(f"inflight{i}", "パン"))
        t.start()
        occupants.append(t)
        deadline = time.time() + 30
        while len(calls) <= i and time.time() < deadline:
            time.sleep(0.01)
        assert len(calls) > i, "worker never dispatched the in-flight request"
    # ...so this request sits queued past its 1s deadline
    t2 = th.Thread(target=fire, args=("queued", "パンパ"))
    t2.start()
    t2.join(timeout=30)
    assert not t2.is_alive()
    assert results["queued"][0] == 504, results["queued"]
    assert "deadline" in results["queued"][1]["error"]
    gate.set()
    for t in occupants:
        t.join(timeout=60)
    # the queued request's text never reached the device
    assert ["パンパ"] not in calls
    stats = _request(server, "GET", "/v1/stats")[1]
    assert stats["timeouts"] >= 1
    # the server still serves afterwards: restore a generous deadline
    # first, since the 1 s test deadline also applies to this request and
    # the released occupants' calls can hold the worker past it
    monkeypatch.setattr(server, "timeout_s", 120.0)
    assert _request(server, "POST", "/v1/synthesize",
                    {"text": "パ", "audiotype": "drum"})[0] == 200


def test_wedged_device_call_fails_group_and_recovers(server, monkeypatch):
    """The watchdog must 504 a group whose device call wedges instead of
    freezing the singleton worker (and every later client) forever — and
    the server must keep serving once the wedge clears."""
    import threading as th

    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    real = Synthesizer.synthesize_batch
    wedge = th.Event()

    def wedged(self, texts, audiotypes, **kw):
        if any(t == "ドンドン" for t in texts):
            wedge.wait(timeout=120)   # a device call that stalls
        return real(self, texts, audiotypes, **kw)

    monkeypatch.setattr(Synthesizer, "synthesize_batch", wedged)
    watchdog = server.device_timeout_s
    monkeypatch.setattr(server, "device_timeout_s", 1.0)
    # pre-warm the wedged text's signature: the 1 s watchdog cap only
    # governs warm signatures (cold ones get the first-call cap), and in
    # isolation no earlier test of this module has warmed this bucket
    server._warm_sigs.add(server.synth.batch_signature(["ドンドン"]))
    status, out = _request(server, "POST", "/v1/synthesize",
                           {"text": "ドンドン", "audiotype": "drum"})
    assert status == 504, out
    assert "timed out" in out["error"]
    wedge.set()   # the stalled thread finishes into a dead outcome dict
    # worker survived: the next request is served normally. The circuit
    # breaker fast-503s until the released thread actually RETURNS, so on
    # a loaded host the instant after wedge.set() may still be breaker-open
    # — poll for recovery instead of asserting the first answer. The real
    # calls run under the server's own watchdog: on a loaded host a real
    # call can outlast 1 s, time out and reopen the breaker itself.
    server.device_timeout_s = watchdog
    import time as _time
    deadline = _time.time() + 60
    while True:
        status, r = _request(server, "POST", "/v1/synthesize",
                             {"text": "パ", "audiotype": "drum"})
        if status == 200 or _time.time() > deadline:
            break
        _time.sleep(0.25)
    assert status == 200 and r["mel_frames"] >= 1, (status, r)


def test_batch_cannot_starve_singles():
    """/v1/batch admission is atomic and leaves batch_queue_reserve slots
    that only /v1/synthesize may use."""
    from visual_onoma_to_wave_tpu_torch.serve import BatchingServer

    class _NoSynth:
        class metadata:
            audiotype_map = {"drum": 0}

        class config:
            class audio:
                sampling_rate = 22050

                class stft:
                    hop_length = 256
        use_image = True
        vocoder_params = None

    srv = BatchingServer(_NoSynth(), port=0, max_queue=8,
                         batch_queue_reserve=2)
    # worker not started: queue state is fully controlled.
    # a flood batch may take at most 8-2=6 slots; 7 items must be rejected
    # whole (all-or-nothing: nothing of it may linger in the queue)
    item = {"text": "パ", "audiotype": "drum"}
    status, out = srv.run_batch([dict(item) for _ in range(7)])
    assert status == 503 and srv._q.qsize() == 0
    # 6 items are admitted (worker absent -> they'd be served; here we only
    # check admission, then drain)
    import threading as th
    t = th.Thread(target=srv.run_batch,
                  args=([dict(item) for _ in range(6)],), daemon=True)
    t.start()
    deadline = 50
    while srv._q.qsize() < 6 and deadline:
        import time
        time.sleep(0.01)
        deadline -= 1
    assert srv._q.qsize() == 6
    # the queue now has only the reserve left: another batch is refused...
    assert srv.run_batch([dict(item)])[0] == 503
    # ...but a single still fits (reserve slots are for singles only)
    ok = {}

    def single():
        ok["r"] = srv.submit(dict(item))

    t2 = th.Thread(target=single, daemon=True)
    t2.start()
    import time
    time.sleep(0.1)
    assert srv._q.qsize() == 7   # the single was admitted
    srv._drain_queue()           # releases both waiters with 503
    t.join(timeout=10)
    t2.join(timeout=10)
    assert ok["r"][0] == 503
    srv.httpd.server_close()


def test_circuit_breaker_fast_fails_while_device_stuck(server, monkeypatch):
    """While a timed-out device call is STILL running (totally wedged
    device), later groups fail FAST with 503 instead of each slow-failing
    through its own watchdog window; once the stuck call returns the
    server recovers."""
    import threading as th
    import time as _time

    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    real = Synthesizer.synthesize_batch
    wedge = th.Event()

    def wedged(self, texts, audiotypes, **kw):
        if any(t == "ドンパン" for t in texts):
            wedge.wait(timeout=120)
        return real(self, texts, audiotypes, **kw)

    monkeypatch.setattr(Synthesizer, "synthesize_batch", wedged)
    # warm the (b, C) signature first: an unwarmed signature gets the
    # 600 s first-call cap and the 1 s watchdog would never fire
    # (keeps this test order-independent); the warm-up is a real call, so
    # it runs under the server's own watchdog, as does the recovery below
    assert _request(server, "POST", "/v1/synthesize",
                    {"text": "パンパン", "audiotype": "drum"})[0] == 200
    watchdog = server.device_timeout_s
    monkeypatch.setattr(server, "device_timeout_s", 1.0)
    try:
        status, out = _request(server, "POST", "/v1/synthesize",
                               {"text": "ドンパン", "audiotype": "drum"})
        assert status == 504, out

        # the wedged thread is still alive -> circuit open -> fast 503
        t0 = _time.perf_counter()
        status, out = _request(server, "POST", "/v1/synthesize",
                               {"text": "パ", "audiotype": "drum"})
        dt = _time.perf_counter() - t0
        assert status == 503, out
        assert "unavailable" in out["error"]
        assert dt < 0.9, f"fast-fail took {dt:.2f}s (watchdog window is 1s)"

        # the outage is visible in /v1/stats
        status, s = _request(server, "GET", "/v1/stats")
        assert status == 200
        assert s["breaker_open"] is True
        assert s["breaker_fast_fails"] >= 1
    finally:
        wedge.set()   # release the stalled thread
        server.device_timeout_s = watchdog
    # circuit closes once the stuck call returns: served normally again
    deadline = _time.time() + 30
    while _time.time() < deadline:
        status, r = _request(server, "POST", "/v1/synthesize",
                             {"text": "パ", "audiotype": "drum"})
        if status == 200:
            break
        _time.sleep(0.2)
    assert status == 200 and r["mel_frames"] >= 1


def test_pipelined_dispatch_overlaps_device_calls(server, monkeypatch):
    """pipeline_depth=2: while group n's device call is in flight the
    worker must collect AND dispatch group n+1 — device call 1 blocks
    until call 2 starts, which only ever happens with pipelining (a
    serial worker would deadlock until the watchdog)."""
    import threading as th

    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    real = Synthesizer.synthesize_batch
    first_started = th.Event()
    second_started = th.Event()
    lock = th.Lock()
    state = {"n": 0}

    def paced(self, texts, audiotypes, **kw):
        with lock:
            state["n"] += 1
            mine = state["n"]
        if mine == 1:
            first_started.set()
            # released only when the SECOND device call begins
            assert second_started.wait(timeout=30), \
                "second dispatch never started: worker is not pipelining"
        elif mine == 2:
            second_started.set()
        return real(self, texts, audiotypes, **kw)

    monkeypatch.setattr(Synthesizer, "synthesize_batch", paced)
    assert server.pipeline_depth >= 2

    out = {}

    def fire(key, text):
        out[key] = _request(server, "POST", "/v1/synthesize",
                            {"text": text, "audiotype": "drum"})

    t1 = th.Thread(target=fire, args=("a", "パン"))
    t1.start()
    assert first_started.wait(timeout=30)
    # first call is now blocked inside the device call; this request must
    # be collected into a NEW group and dispatched concurrently
    t2 = th.Thread(target=fire, args=("b", "パンパ"))
    t2.start()
    t1.join(timeout=60)
    t2.join(timeout=60)
    assert not t1.is_alive() and not t2.is_alive()
    assert out["a"][0] == 200, out["a"]
    assert out["b"][0] == 200, out["b"]


def test_extreme_controls_saturate_not_overflow(server):
    """The allowed control extremes (CONTROL_RANGE bounds) must saturate at
    the model's static mel buffer (mel_len = min(sum(dur), max_mel_len)),
    never overflow or error."""
    from visual_onoma_to_wave_tpu_torch.serve import CONTROL_RANGE

    lo, hi = CONTROL_RANGE
    max_mel = server.synth.config.train.max_mel_len
    for ctl in (lo, hi):
        status, r = _request(server, "POST", "/v1/synthesize",
                             {"text": "パンパンパンパン", "audiotype": "drum",
                              "d_control": ctl})
        assert status == 200, r
        assert 1 <= r["mel_frames"] <= max_mel
        # wav length stays consistent with the reported frames
        wav = base64.b64decode(r["wav_b64"])
        with wave.open(io.BytesIO(wav), "rb") as w:
            assert w.getnframes() == r["mel_frames"] * 256


def test_http_fuzz_never_crashes_server(server):
    """Adversarial/garbage HTTP traffic: every request gets an HTTP answer
    (4xx/2xx), the worker survives, and a normal request still serves."""
    import http.client as hc
    import random

    rng = random.Random(0)
    garbage_bodies = [
        b"", b"null", b"[]", b'"str"', b"{", b"\x00\xff\xfe",
        json.dumps({"text": None}).encode(),
        json.dumps({"text": {"a": 1}}).encode(),
        json.dumps({"items": [None]}).encode(),
        json.dumps({"items": {}}).encode(),
        json.dumps({"text": "パ", "e_control": float("1e309")}).encode(),
        json.dumps({"text": "パ" * 1000}).encode(),
        json.dumps({"text": "パ", "width_rates": [[1.0]]}).encode(),
        json.dumps({"text": "パ", "audiotype": -1}).encode(),
        b'{"text": "\xe3\x83\x91", "d_control": NaN}',   # bare NaN token
        json.dumps({"text": "パ", "extra": "x" * 100000}).encode(),
    ]
    paths = ["/v1/synthesize", "/v1/batch", "/v1/meta", "/", "/healthz"]
    for i in range(60):
        body = rng.choice(garbage_bodies)
        path = rng.choice(paths)
        method = rng.choice(["POST", "POST", "GET"])
        conn = hc.HTTPConnection("127.0.0.1", server.port, timeout=120)
        try:
            conn.request(method, path, body if method == "POST" else None,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            assert 200 <= resp.status < 500, (path, method, body[:40])
            resp.read()
        finally:
            conn.close()
    # the server still serves real traffic
    status, r = _request(server, "POST", "/v1/synthesize",
                         {"text": "パン", "audiotype": "drum"})
    assert status == 200 and r["mel_frames"] >= 1
