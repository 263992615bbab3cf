"""Closed loop with one caller, as `cli synthesize-batch` runs: one
`Synthesizer.synthesize_batch` of the mix's `batch` requests after another,
each call's requests made from (seed, call index), for `seconds`.

The window runs from the first call's start to the end of the call that
crosses `seconds`; every request's own frames (mel_len x hop samples, not
the padded buffer) count as audio. One row of each call, drawn from the
seed, is kept for the comparison, and so is the longest request answered.

A driver is found by the mix's "driver" key (`drivers/<driver>.py`) and
gives `warm_up`, `run`, `control_requests` and `answer`.
"""
from __future__ import annotations

import time

import numpy as np

from pbcore import traffic

WARM_STREAM = 1 << 30      # request streams no window uses


def call_requests(mix: dict, cfg: dict, seed: int, k: int) -> list[dict]:
    ac = cfg["acoustic"]
    return traffic.make_requests(mix, seed, mix["batch"], k, cfg["metadata"]["audiotypes"],
                                 cfg["init"]["acoustic"]["frames_per_char"],
                                 ac["sampling_rate"], ac["hop_length"])


def padded_chars(reqs: list[dict], cfg: dict) -> int:
    """The padded text length the Synthesizer serves a call of `reqs` at."""
    bucket = cfg["acoustic"]["text_bucket"]
    return -(-max(len(r["text"]) for r in reqs) // bucket) * bucket


def synthesize(synth, reqs: list[dict]):
    return synth.synthesize_batch(
        [r["text"] for r in reqs], [r["audiotype"] for r in reqs],
        width_rates=[r["width_rates"] for r in reqs],
        e_control=[r["e_control"] for r in reqs], d_control=[r["d_control"] for r in reqs],
        return_mel=True)


def record(req: dict, res, c: int) -> dict:
    """What the comparison needs of one answer, copied out of the batch."""
    return {"req": req, "C": c, "image": np.array(res.image), "durations": np.array(res.durations),
            "energy": np.array(res.energy), "mel_len": int(res.mel_len),
            "mel": np.array(res.mel), "wav": np.array(res.wav)}


def warm_up(synth, mix: dict, cfg: dict, seed: int, calls: int = 2) -> list[float]:
    """The cell's own shape, `calls` times (kernels built and loaded, cuDNN's
    and the allocator's first calls made) from requests no window sends;
    the seconds of each call."""
    times = []
    for k in range(calls):
        t0 = time.perf_counter()
        synthesize(synth, call_requests(mix, cfg, seed, WARM_STREAM + k))
        times.append(time.perf_counter() - t0)
    return times


def run(synth, mix: dict, cfg: dict, seed: int, seconds: float) -> dict:
    """The window: {"end_to_end", "attempted", "failed", "records" (the
    sampled answers the reference judges), "lines" (printed before the
    result)}."""
    hop, sr = cfg["acoustic"]["hop_length"], cfg["acoustic"]["sampling_rate"]
    keep_rng = traffic.rng(seed, 1 << 22)
    kept, longest, call_s = [], None, []
    frames = requests = failed = calls = 0
    t0 = time.perf_counter()
    while True:
        t_call = time.perf_counter()
        reqs = call_requests(mix, cfg, seed, calls)
        c = padded_chars(reqs, cfg)
        results = synthesize(synth, reqs)
        requests += len(reqs)
        for res in results:
            if res.wav is None or len(res.wav) != res.mel_len * hop:
                failed += 1
            else:
                frames += res.mel_len
        row = int(keep_rng.integers(len(reqs)))
        kept.append(record(reqs[row], results[row], c))
        top = int(np.argmax([r.mel_len for r in results]))
        if longest is None or results[top].mel_len > longest["mel_len"]:
            longest = record(reqs[top], results[top], c)
        calls += 1
        now = time.perf_counter()
        call_s.append(now - t_call)
        if now - t0 >= seconds:
            break
    window = time.perf_counter() - t0
    pick = traffic.rng(seed, 1 << 23).permutation(len(kept))[:mix["sample"]]
    q = np.percentile(call_s, [0, 25, 50, 75, 100]) * 1e3
    return {"end_to_end": {"audio_x_realtime": frames * hop / sr / window},
            "attempted": requests, "failed": failed,
            "records": [kept[i] for i in sorted(pick)] + [longest],
            "lines": [f"window: {window:.4f} s, {calls} calls of {mix['batch']}, "
                      f"{frames * hop / sr:.2f} s of audio; closed loop, no generator lateness",
                      "call ms min / quartiles / max: " + " / ".join(f"{x:.1f}" for x in q)]}


def control_requests(mix: dict, cfg: dict, seed: int) -> list[tuple[dict, int]]:
    """(request, padded text length) of the window's first call, every row:
    what the control answers at the cell's own size."""
    reqs = call_requests(mix, cfg, seed, 0)
    c = padded_chars(reqs, cfg)
    return [(r, c) for r in reqs]


def answer(synth, reqs: list[tuple[dict, int]]) -> list[dict]:
    """The program's records for `control_requests`, answered as one call."""
    res = synthesize(synth, [r for r, _ in reqs])
    return [record(r, x, c) for (r, c), x in zip(reqs, res)]
