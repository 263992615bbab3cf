"""Interactive synthesis demo over the port's `Synthesizer`: a browser UI
served by the standard library (port of visual_onoma_to_wave_tpu/demo_server.py).

The reference's notebook GUI (prediction.ipynb cells 4-6) as one HTML page:
a katakana keypad, a sound-class picker, one width-rate slider per
character, the rendered visual onomatopoeia, the mel figure and audio
playback. Launched with

    python -m visual_onoma_to_wave_tpu_torch.cli demo <config> --acoustic <npz> \\
        --vocoder <npz> [--device cuda]

Endpoints:
    GET  /            the UI page
    GET  /api/meta    {"audiotypes": [...], "has_vocoder": bool, "sampling_rate": int}
    POST /api/synthesize
         {"text", "audiotype", "width_rates", "e_control", "d_control"}
      -> {"durations": [...], "mel_frames": int, "seconds": float,
          "wav_b64": <wav file>|null, "image_b64": <png>|null, "mel_b64": <png>}

Requests run one at a time behind a lock, straight through
`Synthesizer.synthesize` (no micro-batching: that is `serve.py`). The mel
figure is drawn with PIL (`utils/plotting.py`), not matplotlib.
"""
from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

MAX_BODY = 1 << 20       # 1 MB request cap (as serve.py)
MAX_TEXT_LEN = 48        # bounds the render size and the text buckets
WIDTH_RATE_RANGE = (0.05, 8.0)   # clamp of untrusted width rates

# Gojuon + voiced/semi-voiced + small kana + choonpu: the keypad rows of the
# reference demo (prediction.ipynb cell 4).
KEYPAD_ROWS = [
    "アイウエオ",
    "カキクケコ",
    "サシスセソ",
    "タチツテト",
    "ナニヌネノ",
    "ハヒフヘホ",
    "マミムメモ",
    "ヤユヨワヲ",
    "ラリルレロン",
    "ガギグゲゴ",
    "ザジズゼゾ",
    "ダヂヅデド",
    "バビブベボ",
    "パピプペポ",
    "ァィゥェォッャュョー",
]

PAGE = """<!doctype html>
<html lang="ja"><head><meta charset="utf-8">
<title>visual onoma-to-wave demo</title>
<style>
 body { font-family: sans-serif; margin: 2rem auto; max-width: 720px; }
 h1 { font-size: 1.2rem; }
 #keypad button { font-size: 1.05rem; margin: 1px; min-width: 2.1rem; }
 #text { font-size: 1.4rem; width: 100%; }
 .slider-row { display: flex; align-items: center; gap: .5rem; }
 .slider-row label { width: 2rem; font-size: 1.2rem; text-align: center; }
 img { image-rendering: pixelated; border: 1px solid #ccc; margin-top: .5rem; }
 #strip { height: 48px; }
 #melimg { max-width: 100%; }
 #synth { font-size: 1.1rem; padding: .4rem 1.2rem; margin-top: .5rem; }
 .ctl { margin-top: .4rem; }
</style></head><body>
<h1>visual onoma-to-wave — interactive demo</h1>
<div>
 <input id="text" value="" placeholder="オノマトペ (katakana)">
 <button onclick="backspace()">⌫</button>
 <button onclick="clearText()">clear</button>
</div>
<div id="keypad"></div>
<div class="ctl">sound class:
 <select id="audiotype"></select>
 &nbsp; energy ×<input id="e_control" type="number" value="1.0" step="0.1"
                        style="width:4rem">
 &nbsp; duration ×<input id="d_control" type="number" value="1.0" step="0.1"
                          style="width:4rem">
</div>
<div id="sliders"></div>
<button id="synth" onclick="synthesize()">synthesize ♪</button>
<span id="status"></span>
<div><img id="strip" hidden></div>
<div><audio id="player" controls hidden></audio></div>
<div><img id="melimg" hidden></div>
<pre id="durs"></pre>
<script>
const KEYS = %KEYS%;
const textEl = document.getElementById('text');
function addChar(c) { textEl.value += c; renderSliders(); }
function backspace() { textEl.value = textEl.value.slice(0, -1); renderSliders(); }
function clearText() { textEl.value = ''; renderSliders(); }
textEl.addEventListener('input', renderSliders);
const kp = document.getElementById('keypad');
for (const row of KEYS) {
  const div = document.createElement('div');
  for (const ch of row) {
    const b = document.createElement('button');
    b.textContent = ch; b.onclick = () => addChar(ch);
    div.appendChild(b);
  }
  kp.appendChild(div);
}
function renderSliders() {
  const host = document.getElementById('sliders');
  const prev = {};
  for (const r of host.querySelectorAll('input'))
    prev[r.dataset.idx] = r.value;
  host.innerHTML = '';
  [...textEl.value].forEach((ch, i) => {
    const row = document.createElement('div');
    row.className = 'slider-row';
    const lab = document.createElement('label'); lab.textContent = ch;
    const r = document.createElement('input');
    r.type = 'range'; r.min = 0.2; r.max = 3.0; r.step = 0.05;
    r.value = prev[i] !== undefined ? prev[i] : 1.0; r.dataset.idx = i;
    const val = document.createElement('span'); val.textContent = r.value;
    r.oninput = () => val.textContent = r.value;
    row.append(lab, r, val); host.appendChild(row);
  });
}
async function loadMeta() {
  const m = await (await fetch('/api/meta')).json();
  const sel = document.getElementById('audiotype');
  for (const a of m.audiotypes) {
    const o = document.createElement('option'); o.textContent = a;
    sel.appendChild(o);
  }
}
async function synthesize() {
  const rates = [...document.querySelectorAll('#sliders input')]
      .map(r => parseFloat(r.value));
  const body = {
    text: textEl.value,
    audiotype: document.getElementById('audiotype').value,
    width_rates: rates,
    e_control: parseFloat(document.getElementById('e_control').value),
    d_control: parseFloat(document.getElementById('d_control').value),
  };
  const st = document.getElementById('status');
  st.textContent = ' synthesizing…';
  const resp = await fetch('/api/synthesize', {
    method: 'POST', headers: {'Content-Type': 'application/json'},
    body: JSON.stringify(body)});
  if (!resp.ok) { st.textContent = ' error: ' + await resp.text(); return; }
  const r = await resp.json();
  st.textContent = ` ${r.mel_frames} mel frames, ${r.seconds.toFixed(2)} s`;
  document.getElementById('durs').textContent =
      'durations (frames/char): ' + JSON.stringify(r.durations);
  if (r.image_b64) {
    const img = document.getElementById('strip');
    img.src = 'data:image/png;base64,' + r.image_b64; img.hidden = false;
  }
  if (r.mel_b64) {
    const img = document.getElementById('melimg');
    img.src = 'data:image/png;base64,' + r.mel_b64; img.hidden = false;
  }
  if (r.wav_b64) {
    const a = document.getElementById('player');
    a.src = 'data:audio/wav;base64,' + r.wav_b64; a.hidden = false;
    a.play().catch(() => {});
  }
}
loadMeta(); renderSliders();
</script></body></html>
"""


def _png_b64(arr: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _mel_png_b64(mel: np.ndarray, title: str) -> str:
    from visual_onoma_to_wave_tpu_torch.utils.plotting import plot_mel, png_bytes

    return base64.b64encode(png_bytes(plot_mel([(mel, title)]))).decode("ascii")


class DemoServer:
    """Threaded HTTP server over a `Synthesizer`; one request at a time
    through a lock."""

    def __init__(self, synthesizer, host: str = "127.0.0.1", port: int = 0):
        self.synth = synthesizer
        self._lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code: int, body: bytes, ctype: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    page = PAGE.replace("%KEYS%", json.dumps(KEYPAD_ROWS))
                    self._send(200, page.encode(), "text/html; charset=utf-8")
                elif self.path == "/api/meta":
                    meta = {
                        "audiotypes": list(server.synth.metadata.audiotype_map),
                        "has_vocoder": server.synth.vocoder is not None,
                        "sampling_rate": server.synth.config.audio.sampling_rate,
                    }
                    self._send(200, json.dumps(meta).encode())
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path != "/api/synthesize":
                    return self._send(404, b"not found", "text/plain")
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    if not 0 <= n <= MAX_BODY:
                        return self._send(413, b"request too large", "text/plain")
                    req = json.loads(self.rfile.read(n) or b"{}")
                    self._send(200, json.dumps(server.handle_synthesize(req)).encode())
                except Exception as e:  # the message goes to the page
                    self._send(400, str(e).encode(), "text/plain")

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------
    def handle_synthesize(self, req: dict) -> dict:
        text = req.get("text", "")
        if not isinstance(text, str) or not text:
            raise ValueError("empty text")
        if len(text) > MAX_TEXT_LEN:
            raise ValueError(f"text too long (max {MAX_TEXT_LEN} chars)")
        rates = req.get("width_rates") or None
        if rates is not None and len(rates) != len(text):
            rates = None
        if rates is not None:
            # fontsize * rate is a PIL image width: an absurd rate would
            # allocate gigabytes in the render
            lo, hi = WIDTH_RATE_RANGE
            rates = [min(max(float(r), lo), hi) for r in rates]
        with self._lock:
            res = self.synth.synthesize(
                text, req.get("audiotype", 0), width_rates=rates,
                e_control=float(req.get("e_control", 1.0)),
                d_control=float(req.get("d_control", 1.0)))
        sr = self.synth.config.audio.sampling_rate
        hop = self.synth.config.audio.stft.hop_length
        out = {
            "durations": [int(d) for d in res.durations],
            "mel_frames": int(res.mel.shape[0]),
            "seconds": float(res.mel.shape[0] * hop / sr),
            "wav_b64": None,
            "image_b64": _png_b64(res.image) if res.image is not None else None,
            "mel_b64": _mel_png_b64(res.mel, text),
        }
        if res.wav is not None:
            from visual_onoma_to_wave_tpu_torch.data.audio_io import wav_bytes

            out["wav_b64"] = base64.b64encode(wav_bytes(res.wav, sr)).decode("ascii")
        return out

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def serve_forever(self) -> None:
        print(f"demo: http://{self.httpd.server_address[0]}:{self.port}/ (Ctrl-C to stop)",
              flush=True)
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.httpd.server_close()
