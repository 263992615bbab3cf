"""The synthetic onomatopoeia corpus of the examples and the acoustic floor
(copy of the corpus half of examples/train_demo_artifacts.py).

A deterministic corpus with a real character -> timbre correspondence: every
katakana character maps to a fixed chromatic pitch (220 Hz * 2^(k/12)), the
sound class sets the envelope (drum = damped noise-burst strike, bell =
slow-decay harmonic stack), and per-character durations vary per clip, so
the glyph widths carry information. `build_corpus` writes it in the raw
RWCP-SSD layout that `data.formatting` reads; `work_config` is the config
of a run on it, and `DEMO_MODEL` the model block of the committed demo
checkpoint trained on it. Nothing here needs a corpus download.
"""
from __future__ import annotations

import pathlib

import numpy as np

SR_RAW = 48000
KATAKANA = "パンドトカバチリコウシポ"
CLASSES = ("drum", "bell")

# the demo checkpoint's geometry (examples/checkpoints/demo): hidden 128,
# 2 + 2 FFT layers; the ICASSP model is the default `Config`
DEMO_MODEL = {
    "transformer": {"encoder_layer": 2, "decoder_layer": 2,
                    "encoder_head": 2, "decoder_head": 2,
                    "encoder_hidden": 128, "decoder_hidden": 128,
                    "conv_filter_size": 512, "conv_kernel_size": [9, 1]},
    "visual_feature_extractor": {"layer_num": 2},
    "max_seq_len": 512,
    "postnet_channels": 128,
    "vocoder_kwargs": {"upsample_initial_channel": 128},
}


def _pitch(ch: str) -> float:
    """Injective char -> pitch over KATAKANA: each demo character gets its
    own chromatic step (collisions would silently merge timbres and erase
    the char -> sound correspondence the demo claims)."""
    k = KATAKANA.index(ch) if ch in KATAKANA else ord(ch) % 24
    return 220.0 * 2.0 ** (k / 12.0)


def _char_tone(cls: str, f: float, n: int, rng) -> np.ndarray:
    t = np.arange(n) / SR_RAW
    if cls == "drum":
        env = np.exp(-t * 18.0)
        tone = np.sin(2 * np.pi * f * t)
        noise = rng.normal(0, 0.25, n) * np.exp(-t * 60.0)
        out = (0.6 * tone + noise) * env
    else:  # bell: harmonic stack, slow decay
        env = np.exp(-t * 6.0)
        out = env * sum(a * np.sin(2 * np.pi * f * h * t)
                        for a, h in ((0.6, 1.0), (0.25, 2.76), (0.15, 5.40)))
    return (0.7 * out).astype(np.float32)


def synth_clip(rng, text: str, cls: str):
    """48 kHz clip + julius-style .lab lines; per-char durations vary."""
    lead = tail = 0.10
    durs = rng.uniform(0.12, 0.28, len(text))
    total = lead + float(durs.sum()) + tail
    wav = np.zeros(int(total * SR_RAW), np.float32)
    lab = [f"0.0000 {lead:.4f} silB"]
    cur = lead
    for ch, d in zip(text, durs):
        i0 = int(cur * SR_RAW)
        n = int(d * SR_RAW)
        wav[i0:i0 + n] += _char_tone(cls, _pitch(ch), n, rng)
        lab.append(f"{cur:.4f} {cur + d:.4f} {ch}")
        cur += float(d)
    lab.append(f"{cur:.4f} {total:.4f} silE")
    return np.clip(wav, -1, 1), lab


def build_corpus(root: pathlib.Path, n_per_class: int, seed: int = 0):
    """Deterministic corpus in the REAL RWCP-SSD layout (see 01_format.py /
    data/formatting.py): audio under nospeech/drysrc/<take>/<cls>/48khz/,
    4-field .ono rows keyed by onomatopoeia_id, 4-field .acc rows, labs
    named <clip>-<onomatopoeia_id>.lab next to the .ono files."""
    raw_root = root / "RWCP-SSD"
    ono_root = root / "onoma"
    rng = np.random.default_rng(seed)
    for cls in CLASSES:
        d48 = raw_root / "nospeech" / "drysrc" / "c1" / cls / "48khz"
        d48.mkdir(parents=True, exist_ok=True)
        od = ono_root / "c1" / cls
        od.mkdir(parents=True, exist_ok=True)
        for k in range(n_per_class):
            n_chars = int(rng.integers(2, 6))
            text = "".join(rng.choice(list(KATAKANA), n_chars))
            wav, lab = synth_clip(rng, text, cls)
            num, ono_id = f"{k:03d}", f"0704_{k:03d}"
            (d48 / f"{num}.raw").write_bytes(
                (np.clip(wav, -1, 1) * 32767).astype("<i2").tobytes())
            (od / f"{num}.ono").write_text(f"w1,{ono_id},{text},5\n")
            (od / f"{num}.acc").write_text(
                f"{ono_id},{text},w2,4\n{ono_id},{text},w3,5\n")
            (od / f"{num}-{ono_id}.lab").write_text("\n".join(lab) + "\n")
    return raw_root, ono_root


def work_config(root: pathlib.Path, ono_root, steps: int) -> dict:
    """The config dict of a run on the corpus under `root` (the examples'
    paths, split and training cadence; no model block, so the model is the
    ICASSP geometry unless the caller adds one)."""
    return {
        "path": {
            "corpus": str(ono_root),
            "formatted": str(root / "formatted"),
            "preprocessed": str(root / "preprocessed"),
            "font": "",
            "ckpt": str(root / "out" / "ckpt"),
            "log": str(root / "out" / "log"),
            "result": str(root / "out" / "result"),
        },
        "dataset": {"extract_labels": list(CLASSES), "valtest_id": [13, 33],
                    "confidence_score_border": 3.0,
                    "acceptance_score_border": 2.5},
        "train": {
            "optimizer": {"batch_size": 16, "warm_up_step": 400},
            "step": {"total_step": steps, "log_step": 200,
                     "synth_step": 10**9, "val_step": max(500, steps // 4),
                     "save_step": steps},
            "max_mel_len": 512, "seed": 0,
        },
    }
