"""Micro-batching HTTP server over the port's `Synthesizer` (copy of
visual_onoma_to_wave_tpu/serve.py).

Concurrent single requests are batched into one `Synthesizer.synthesize_batch`
call (one fused acoustic + vocoder step on the card per batch):

  * handler threads enqueue requests and wait on per-request events;
  * one worker thread drains the queue into batches of up to `max_batch`
    within a `batch_window_ms` window, and runs each batch's call on a
    dispatch thread, so that it can collect and dispatch batch n + 1 while
    batch n runs (`pipeline_depth` calls in flight);
  * e/d controls are per-item inputs, so requests with different controls
    share a batch;
  * a batch whose call fails is retried item by item, so one bad request
    cannot fail the others; malformed requests (types, lengths, unknown
    audiotypes, non-finite numbers) get 400 at the HTTP edge;
  * every request has a deadline (`request_timeout_s`): expired queued
    requests get 504 without device work, and each device call runs under
    a watchdog; while a timed-out call is still running, new batches fail
    fast with 503 (circuit breaker);
  * /v1/batch admission is all or nothing, and keeps a reserve of queue
    slots for /v1/synthesize singles;
  * failure details are logged server-side only.

Endpoints:
    GET  /healthz          -> {"ok": true}
    GET  /v1/meta          -> audiotypes, sampling rate, limits
    GET  /v1/stats         -> request/batch counters, mean batch size, latency quantiles (ms)
    POST /v1/synthesize    -> {"text", "audiotype", "width_rates"?, "e_control"?, "d_control"?}
         returns {"wav_b64"?, "sample_rate", "mel_frames", "durations", "seconds"}
    POST /v1/batch         -> {"items": [<as /v1/synthesize>, ...]} -> {"items": [...]}
"""
from __future__ import annotations

import base64
import collections
import json
import logging
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_log = logging.getLogger("visual_onoma_to_wave_tpu_torch.serve")

MAX_TEXT_LEN = 64
LATENCY_WINDOW = 1000            # latency samples kept for the stats quantiles
MAX_BODY_BYTES = 1 << 20         # request-body cap
WIDTH_RATE_RANGE = (0.05, 8.0)   # glyph-stretch bounds
CONTROL_RANGE = (0.05, 20.0)     # e/d control bounds


def _in_range(v, lo: float, hi: float) -> bool:
    """Bounds-check an untrusted JSON number without raising: rejects bools,
    non-numbers, NaN/inf, values out of range and integers too large for a float."""
    if not isinstance(v, (int, float)) or isinstance(v, bool):
        return False
    try:
        f = float(v)
    except OverflowError:
        return False
    return lo <= f <= hi


class _Pending:
    __slots__ = ("req", "event", "result", "error", "error_code", "t0", "deadline")

    def __init__(self, req: dict, timeout_s: float):
        self.req = req
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.error_code = 500
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + timeout_s


class BatchingServer:
    """Micro-batching HTTP front end for a `Synthesizer`."""

    def __init__(self, synthesizer, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 32, batch_window_ms: float = 5.0, max_queue: int = 1024,
                 request_timeout_s: float = 30.0, device_timeout_s: float | None = None,
                 batch_queue_reserve: int | None = None, pipeline_depth: int = 2):
        self.synth = synthesizer
        self.max_batch = int(max_batch)
        # the server's text cap, tightened to an ExportedSynthesizer's largest
        # text bucket: an over-limit text gets a 400 at the edge and never
        # fails a micro-batch group in the worker
        self.max_text_len = min(MAX_TEXT_LEN,
                                int(getattr(synthesizer, "max_text_len", MAX_TEXT_LEN)))
        self.window_s = float(batch_window_ms) / 1e3
        self.timeout_s = float(request_timeout_s)
        # watchdog of one device call; a signature's first call (kernel
        # builds, cuDNN autotuning) gets the longer cold cap
        self.device_timeout_s = (float(device_timeout_s) if device_timeout_s is not None
                                 else self.timeout_s)
        self.cold_timeout_s = max(600.0, self.device_timeout_s)
        self._warm_sigs: set = set()
        # timed-out device calls still running: while any is alive, batches fail fast
        self._stuck_calls: list[threading.Thread] = []
        self.pipeline_depth = max(1, int(pipeline_depth))
        self.batch_reserve = (int(batch_queue_reserve) if batch_queue_reserve is not None
                              else max(1, int(max_queue) // 8))
        # bounded queue = backpressure: past max_queue waiting requests, 503
        self._q: "queue.Queue[_Pending]" = queue.Queue(maxsize=int(max_queue))
        self._stop = threading.Event()
        # held around {check _stop, enqueue} and {set _stop, final drain}, so
        # that no submitter can enqueue after the shutdown drain
        self._submit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0, "errors": 0,
                      "timeouts": 0, "breaker_fast_fails": 0}
        self._latencies: collections.deque = collections.deque(maxlen=LATENCY_WINDOW)

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, obj) -> None:
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._send(200, {"ok": True})
                elif self.path == "/v1/meta":
                    self._send(200, server.meta())
                elif self.path == "/v1/stats":
                    self._send(200, server.snapshot_stats())
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if n > MAX_BODY_BYTES:
                        return self._send(413, {"error": f"body exceeds {MAX_BODY_BYTES} bytes"})
                    req = json.loads(self.rfile.read(n) or b"{}")
                except Exception as e:  # malformed body
                    return self._send(400, {"error": str(e)})
                if not isinstance(req, dict):
                    return self._send(400, {"error": "request body must be a JSON object"})
                if self.path == "/v1/synthesize":
                    self._send(*server.submit(req))
                elif self.path == "/v1/batch":
                    self._send(*server.run_batch(req.get("items", [])))
                else:
                    self._send(404, {"error": "not found"})

        class _Server(ThreadingHTTPServer):
            # the default accept backlog (5) resets connections under bursts
            request_queue_size = 256

        self.httpd = _Server((host, port), Handler)
        self.port = self.httpd.server_port
        self.host = host
        self._worker = threading.Thread(target=self._work, daemon=True)
        self._server_thread: threading.Thread | None = None

    # ------------------------------------------------------------- control
    def start(self) -> None:
        self._worker.start()
        self._server_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._server_thread.start()

    def warmup(self) -> None:
        """One call before taking traffic: builds the kernels on first use
        and lets cuDNN pick its algorithms, so that the watchdog never
        misreads a cold first call as a wedged one."""
        at = next(iter(self.synth.metadata.audiotype_map))
        t0 = time.perf_counter()
        self.synth.synthesize_batch(["a"], [at], return_mel=False)
        self._warm_sigs.add(self.synth.batch_signature(["a"]))
        _log.info("warmup call done in %.1fs", time.perf_counter() - t0)

    def serve_forever(self) -> None:
        print("warming up...")
        self.warmup()
        self._worker.start()
        print(f"serving on http://{self.host}:{self.port} (max_batch={self.max_batch}, "
              f"window={self.window_s * 1e3:.0f}ms, timeout={self.timeout_s:.0f}s)")
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        self._stop.set()
        if self._worker.is_alive():
            # the worker fails still-queued requests on exit; give it a moment
            self._worker.join(timeout=30.0)
        with self._submit_lock:
            self._drain_queue()
        self.httpd.shutdown()
        self.httpd.server_close()

    def _drain_queue(self) -> None:
        """Fail any still-queued requests so that their handler threads return."""
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                return
            p.error = "server is shutting down"
            p.error_code = 503
            p.event.set()

    # ------------------------------------------------------------ requests
    def meta(self) -> dict:
        return {
            "audiotypes": list(self.synth.metadata.audiotype_map),
            "has_vocoder": self.synth.vocoder_params is not None,
            "sampling_rate": self.synth.config.audio.sampling_rate,
            "max_batch": self.max_batch,
            "max_text_len": self.max_text_len,
            "max_queue": self._q.maxsize,
            "pipeline_depth": self.pipeline_depth,
            "request_timeout_s": self.timeout_s,
            "batch_queue_reserve": self.batch_reserve,
            "width_rate_range": list(WIDTH_RATE_RANGE),
            "control_range": list(CONTROL_RANGE),
        }

    def reset_stats(self) -> None:
        with self._stats_lock:
            self.stats = {k: 0 for k in self.stats}
            self._latencies.clear()

    def snapshot_stats(self) -> dict:
        with self._stats_lock:
            lat = sorted(self._latencies)
            s = dict(self.stats)
        if lat:
            s["latency_ms_p50"] = round(1e3 * lat[len(lat) // 2], 2)
            s["latency_ms_p95"] = round(1e3 * lat[int(len(lat) * 0.95)], 2)
        s["mean_batch_size"] = (round(s["batched_requests"] / s["batches"], 2)
                                if s["batches"] else 0.0)
        # read-only: pruning the list belongs to the worker thread
        s["breaker_open"] = any(t.is_alive() for t in self._stuck_calls)
        return s

    def _validate(self, req) -> str | None:
        """Type and range checks at the HTTP edge: whatever would raise in the
        worker is a 400 here."""
        if not isinstance(req, dict):
            return "each request must be a JSON object"
        text = req.get("text", "")
        if not isinstance(text, str) or not 1 <= len(text) <= self.max_text_len:
            return f"text must be a string of 1..{self.max_text_len} characters"
        if any(c in "{}\n\r" for c in text):
            return "text must not contain braces or newlines"
        at = req.get("audiotype", 0)
        atypes = self.synth.metadata.audiotype_map
        if isinstance(at, str):
            if at not in atypes:
                return f"unknown audiotype {at!r}"
        elif isinstance(at, int) and not isinstance(at, bool):
            if not 0 <= at < len(atypes):
                return f"audiotype id must be 0..{len(atypes) - 1}"
        else:
            return "audiotype must be a class name or integer id"
        if not self.synth.use_image:
            # the text path synthesises from token ids: out of vocabulary is an error
            missing = sorted({c for c in text if c not in self.synth.symbol_map})
            if missing:
                return f"characters not in the vocabulary: {missing[:5]}"
        lo, hi = WIDTH_RATE_RANGE
        wr = req.get("width_rates")
        if wr is not None:
            if not isinstance(wr, list) or not all(_in_range(x, lo, hi) for x in wr):
                return f"width_rates must be a list of numbers in [{lo}, {hi}]"
            if len(wr) != len(text):
                return "width_rates length must match text"
        clo, chi = CONTROL_RANGE
        for key in ("e_control", "d_control"):
            if not _in_range(req.get(key, 1.0), clo, chi):
                return f"{key} must be a number in [{clo}, {chi}]"
        return None

    def submit(self, req: dict) -> tuple[int, dict]:
        """Queue one request; block until it is served or its deadline passes (504)."""
        err = self._validate(req)
        if err:
            return 400, {"error": err}
        p = _Pending(req, self.timeout_s)
        with self._submit_lock:
            if self._stop.is_set():
                return 503, {"error": "server is shutting down"}
            try:
                self._q.put_nowait(p)
            except queue.Full:
                with self._stats_lock:
                    self.stats["errors"] += 1
                return 503, {"error": "server overloaded (queue full)"}
        served = p.event.wait(timeout=max(0.0, p.deadline - time.perf_counter()) + 0.05)
        with self._stats_lock:
            self.stats["requests"] += 1
            self._latencies.append(time.perf_counter() - p.t0)
            if not served or p.error:
                self.stats["errors"] += 1
            if not served or p.error_code == 504:
                self.stats["timeouts"] += 1
        if not served:
            return 504, {"error": "request deadline exceeded"}
        if p.error:
            return p.error_code, {"error": p.error}
        return 200, p.result

    def run_batch(self, items) -> tuple[int, dict]:
        """An explicit batch, admitted whole or refused whole inside the
        submit lock, and never into the last `batch_reserve` queue slots."""
        if not isinstance(items, list) or not items:
            return 400, {"error": "items must be a non-empty list"}
        for it in items:
            err = self._validate(it)
            if err:
                return 400, {"error": err}
        pend = [_Pending(it, self.timeout_s) for it in items]
        with self._submit_lock:
            if self._stop.is_set():
                return 503, {"error": "server is shutting down"}
            free = self._q.maxsize - self._q.qsize()
            if len(pend) > max(0, free - self.batch_reserve):
                with self._stats_lock:
                    self.stats["errors"] += len(pend)
                return 503, {"error": "server overloaded (queue full)"}
            for p in pend:
                self._q.put_nowait(p)
        deadline = pend[0].deadline
        timed_out = False
        for p in pend:
            if not p.event.wait(timeout=max(0.0, deadline - time.perf_counter()) + 0.05):
                timed_out = True
                break
        with self._stats_lock:
            self.stats["requests"] += len(pend)
            self._latencies.extend(time.perf_counter() - p.t0 for p in pend)
            self.stats["errors"] += (len(pend) if timed_out
                                     else sum(1 for p in pend if p.error))
            if timed_out:
                self.stats["timeouts"] += 1
        if timed_out:
            return 504, {"error": "request deadline exceeded"}
        first_err = next((p for p in pend if p.error), None)
        if first_err is not None:
            return first_err.error_code, {"error": first_err.error}
        return 200, {"items": [p.result for p in pend]}

    # -------------------------------------------------------------- worker
    def _work(self) -> None:
        try:
            self._work_loop()
        finally:
            self._drain_queue()

    def _collect_group(self, block: bool) -> list[_Pending]:
        """Up to max_batch requests within the batching window. block=True
        waits briefly for a first item; block=False returns [] at once."""
        try:
            first = self._q.get(timeout=0.1) if block else self._q.get_nowait()
        except queue.Empty:
            return []
        group = [first]
        window_end = time.perf_counter() + self.window_s
        while len(group) < self.max_batch:
            left = window_end - time.perf_counter()
            if left <= 0:
                break
            try:
                group.append(self._q.get(timeout=left))
            except queue.Empty:
                break
        now = time.perf_counter()
        for p in group:     # expired while queued: 504 with no device work
            if p.deadline < now:
                p.error = "request deadline exceeded"
                p.error_code = 504
                p.event.set()
        return [p for p in group if not p.event.is_set()]

    def _work_loop(self) -> None:
        """The one worker; it must never die. Up to pipeline_depth device
        calls in flight, retired in dispatch order."""
        inflight: collections.deque = collections.deque()
        while not self._stop.is_set():
            group = []
            try:
                while len(inflight) < self.pipeline_depth:
                    group = self._collect_group(block=not inflight)
                    if not group:
                        break
                    flight = self._dispatch_group(group)
                    group = []
                    if flight is not None:
                        inflight.append(flight)
                if not inflight:
                    continue
                if len(inflight) >= self.pipeline_depth:
                    self._retire_safe(inflight.popleft())
                else:
                    # poll the head briefly, then look at the queue again
                    head = inflight[0]
                    head.thread.join(timeout=0.005)
                    if not head.thread.is_alive() or time.perf_counter() >= head.deadline:
                        inflight.popleft()
                        self._retire_safe(head)
            except Exception as e:  # pragma: no cover - defensive
                _log.exception("worker loop error", exc_info=e)
                for p in group:
                    if not p.event.is_set():
                        p.error = p.error or "synthesis failed"
                        p.event.set()
        while inflight:
            self._retire_safe(inflight.popleft())

    def _retire_safe(self, f: "_Flight") -> None:
        try:
            self._retire(f)
        except Exception as e:  # pragma: no cover - defensive
            _log.exception("retire error", exc_info=e)
            for p in f.live:
                if not p.event.is_set():
                    p.error = p.error or "synthesis failed"
                    p.event.set()

    class _Flight:
        __slots__ = ("live", "outcome", "thread", "sig", "deadline", "record_stats")

    def _circuit_open(self) -> bool:
        """True while a timed-out device call is still running."""
        if not self._stuck_calls:
            return False
        self._stuck_calls[0].join(timeout=0.25)
        self._stuck_calls = [t for t in self._stuck_calls if t.is_alive()]
        return bool(self._stuck_calls)

    def _dispatch_group(self, live: list[_Pending],
                        record_stats: bool = True) -> "_Flight | None":
        """Start one batch's device call; None when the breaker failed it fast."""
        if self._circuit_open():
            _log.error("circuit open: failing a %d-item group fast", len(live))
            for p in live:
                p.error = "device unavailable (recovering from a stuck call)"
                p.error_code = 503
            with self._stats_lock:
                self.stats["breaker_fast_fails"] += len(live)
            self._finish(live, record_stats=False)
            return None
        f = BatchingServer._Flight()
        f.live = live
        f.outcome = {}
        f.record_stats = record_stats
        f.sig = self.synth.batch_signature([p.req["text"] for p in live])
        timeout = self.device_timeout_s if f.sig in self._warm_sigs else self.cold_timeout_s
        f.deadline = time.perf_counter() + timeout
        f.thread = threading.Thread(target=self._device_call, args=(f.live, f.outcome),
                                    daemon=True, name="vow-serve-device-call")
        f.thread.start()
        return f

    def _retire(self, f: "_Flight") -> None:
        """Join one in-flight call under its watchdog, then fill the results
        or isolate the failing request."""
        live, outcome, record_stats = f.live, f.outcome, f.record_stats
        f.thread.join(timeout=max(0.0, f.deadline - time.perf_counter()))
        if f.thread.is_alive():
            _log.error("device call exceeded its watchdog for a %d-item group", len(live))
            self._stuck_calls.append(f.thread)
            for p in live:
                p.error = "synthesis timed out"
                p.error_code = 504
            self._finish(live, record_stats)
            return
        self._warm_sigs.add(f.sig)
        if "exc" in outcome:
            _log.exception("synthesis failed for a %d-item group", len(live),
                           exc_info=outcome["exc"])
            if len(live) > 1:
                # retry one by one; the retries do not count as batches
                for p in live:
                    self._serve_group([p], record_stats=False)
                if record_stats:
                    with self._stats_lock:
                        self.stats["batches"] += 1
                        self.stats["batched_requests"] += len(live)
                return
            live[0].result = None
            live[0].error = "synthesis failed"
        else:
            for p, r in zip(live, outcome["results"]):
                p.result = r
        self._finish(live, record_stats)

    def _serve_group(self, group: list[_Pending], record_stats: bool = True) -> None:
        f = self._dispatch_group(group, record_stats)
        if f is not None:
            self._retire(f)

    def _device_call(self, live: list[_Pending], outcome: dict) -> None:
        """One batch through the Synthesizer; the JSON answers (or the
        exception) go to `outcome` only, so that a timed-out call never races
        the worker on the requests."""
        from visual_onoma_to_wave_tpu_torch.data.audio_io import wav_bytes

        sr = self.synth.config.audio.sampling_rate
        hop = self.synth.config.audio.stft.hop_length
        try:
            results = self.synth.synthesize_batch(
                [p.req["text"] for p in live], [p.req.get("audiotype", 0) for p in live],
                width_rates=[p.req.get("width_rates") for p in live],
                e_control=[float(p.req.get("e_control", 1.0)) for p in live],
                d_control=[float(p.req.get("d_control", 1.0)) for p in live],
                return_mel=False)
            outcome["results"] = [{
                "sample_rate": sr,
                "mel_frames": int(r.mel_len),
                "durations": [int(d) for d in r.durations],
                "seconds": float(r.mel_len * hop / sr),
                "wav_b64": (base64.b64encode(wav_bytes(np.asarray(r.wav), sr)).decode()
                            if r.wav is not None else None),
            } for r in results]
        except Exception as e:
            outcome["exc"] = e

    def _finish(self, group: list[_Pending], record_stats: bool = True) -> None:
        if record_stats:
            with self._stats_lock:
                self.stats["batches"] += 1
                self.stats["batched_requests"] += len(group)
        for p in group:
            p.event.set()
