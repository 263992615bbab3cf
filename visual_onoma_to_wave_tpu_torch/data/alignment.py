"""TextGrid alignment -> per-character frame durations (copy of
visual_onoma_to_wave_tpu/data/alignment.py).

The label timeline is rescaled so that its last boundary meets the wav's
length; `margin_frame` frames of silence are kept before the first and after
the last non-silence label (clamped to [0, end]); a character's duration is
round(end * sr / hop) - round(start * sr / hop), so the durations sum to the
frame count of the trimmed region. Every boundary is rescaled alike (the
JAX package's recorded divergence from the reference, which leaves interior
boundaries in label time).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from visual_onoma_to_wave_tpu_torch.data.labels import SILENCE_LABELS, Interval


@dataclass
class Alignment:
    characters: list[str]
    durations: np.ndarray      # int32, per character
    start: float               # trim start (s, wav time)
    end: float                 # trim end (s, wav time)


def align_tier(intervals: list[Interval], num_samples: int, sampling_rate: int = 22050,
               hop_length: int = 256, margin_frame: int = 5) -> Alignment:
    wav_sec = num_samples / sampling_rate
    margin_sec = margin_frame * hop_length / sampling_rate
    chars: list[str] = []
    starts, ends = [], []
    start_t = end_t = last_t = 0.0
    end_idx = 0
    for iv in intervals:
        p = iv.text
        if not chars:
            if p in SILENCE_LABELS:
                continue
            start_t = iv.start
        if p not in SILENCE_LABELS:
            chars.append(p)
            end_t = iv.end
            end_idx = len(chars)
        else:
            chars.append("sp")
            last_t = iv.end
        starts.append(iv.start)
        ends.append(iv.end)
    if last_t <= 0:       # no trailing silence: scale by the final boundary
        last_t = ends[-1] if ends else wav_sec

    scale = wav_sec / last_t
    start_t, end_t, last_t = start_t * scale, end_t * scale, last_t * scale
    starts_np = np.asarray(starts, dtype=np.float64) * scale
    ends_np = np.asarray(ends, dtype=np.float64) * scale
    start_t = max(0.0, start_t - margin_sec)
    starts_np[0] = start_t
    end_t = min(last_t, end_t + margin_sec)
    if len(ends_np) >= 2:
        ends_np[-2] = end_t
    frames = (np.round(ends_np * sampling_rate / hop_length)
              - np.round(starts_np * sampling_rate / hop_length))
    return Alignment(characters=chars[:end_idx],
                     durations=frames.astype(np.int64)[:end_idx].astype(np.int32),
                     start=float(start_t), end=float(end_t))
