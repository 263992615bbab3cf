"""The one traffic generator: every mix under `traffic/` is a JSON file of
parameters that this module reads.

A request is {"text", "audiotype", "width_rates", "e_control", "d_control",
"target_frames"}. Every seed gives the same set of sizes (characters and
clip lengths), each drawn at stratified quantiles of the mix's
distribution and put in an order drawn from the seed; the seed also
draws the characters, the width rates and the sound classes. So two seeds
differ in content and order, not in the amount of work.

Mix keys:
  driver        the driver that runs the window, `drivers/<driver>.py`
                ("offline": closed loop, one caller, `synthesize_batch` of
                `batch` requests a call)
  chars         [lo, hi] characters a text, inclusive
  clip_frames   [lo, hi] mel frames a clip aims at (or clip_seconds)
  clip_dist     "uniform" or "log_uniform"
  width_rate    [lo, hi] glyph width rates, uniform
  e_control     the energy control of every request
  batch         (offline) requests a call
  sample        requests compared with the reference after the window
"""
from __future__ import annotations

import numpy as np

# the katakana block U+30A2 (ア) .. U+30F3 (ン): what onomatopoeia are written in
KATAKANA = tuple(chr(c) for c in range(0x30A2, 0x30F4))


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for `seed` (any whole number) and a stream of indices."""
    return np.random.default_rng([int(seed) % 2 ** 64, *stream])


def stratified(n: int, gen: np.random.Generator) -> np.ndarray:
    """The quantiles (i + 0.5) / n, i < n, in an order drawn from `gen`."""
    return gen.permutation((np.arange(n) + 0.5) / n)


def clip_frames(mix: dict, u: np.ndarray, sampling_rate: int, hop: int) -> np.ndarray:
    """Mel frames at quantiles `u` of the mix's clip distribution."""
    if "clip_seconds" in mix:
        lo, hi = (s * sampling_rate / hop for s in mix["clip_seconds"])
    else:
        lo, hi = mix["clip_frames"]
    if mix.get("clip_dist", "uniform") == "log_uniform":
        return np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    return lo + u * (hi - lo)


def make_requests(mix: dict, seed: int, n: int, stream: int, audiotypes, frames_per_char: float,
                  sampling_rate: int, hop: int) -> list[dict]:
    """`n` requests of the mix. The number of characters cycles through the
    mix's range and the clip lengths sit at stratified quantiles, each put in
    an order drawn from (seed, stream); d_control scales the model's
    `frames_per_char` (at d_control 1) to the clip's length."""
    g = rng(seed, stream)
    lo, hi = mix["chars"]
    chars = g.permutation(lo + np.arange(n) % (hi - lo + 1))
    frames = clip_frames(mix, stratified(n, g), sampling_rate, hop)
    wlo, whi = mix["width_rate"]
    reqs = []
    for i in range(n):
        k = int(chars[i])
        reqs.append({
            "text": "".join(KATAKANA[j] for j in g.integers(0, len(KATAKANA), k)),
            "audiotype": audiotypes[int(g.integers(0, len(audiotypes)))],
            "width_rates": [float(x) for x in np.round(g.uniform(wlo, whi, k), 4)],
            "e_control": float(mix.get("e_control", 1.0)),
            "d_control": float(np.round(frames[i] / (frames_per_char * k), 6)),
            "target_frames": float(frames[i]),
        })
    return reqs
