#!/usr/bin/env python3
"""Long vocoder training arms through the PyTorch port: the port's
counterpart of `benchmarks/bench_vocoder_longrun.py`, scored as
`benchmarks/bench_vocoder_quality.py` scores, with nothing of JAX.

    python3 tools/vocoder_longrun_torch.py [--families istftnet-mel,hifigan]
        [--steps 20000] [--every 2000] [--ema 0.9999] [--batch 16]
        [--segment-size 8192] [--lr 2e-4] [--clip 0] [--disc msd|mrd]
        [--factor 4] [--patience 5] [--seed 0] [--device cuda]

Trains each family from scratch to --steps GAN steps (the port's
`VocoderTrainer`, the generator's EMA at --ema, the watchdog armed with
on_divergence "halt" and a log window of 250 steps; --seed seeds its initial
weights and its segment sampler) on the deterministic
corpus of the reference benches: 24 structured bell / drum clips at 22.05
kHz from numpy's `default_rng(0)`, the first 20 trained on, the last 4
held out. Every --every steps it scores copy-synthesis on the held-out
clips, for the raw generator and its EMA: each clip cut to whole hops ->
its log-mel (`ops/stft.logmel_and_energy`) -> the generator in `.eval()`
(the MRF kernel B2 on the card for HiFi-GAN and iSTFTNet, the ConvNeXt
kernel B4 for Vocos) -> the first len(clip) samples clipped to [-1, 1] ->
log-mel again; mel L1 and MCD over the common frames, and the
multi-resolution STFT distance to the clip (`metrics.py`), means over the
clips, unrounded (`tools/eval_quality_demo_torch.py::make_scorer`, the
reference's `make_scorer` step for step). One JSON line per (family, step,
iterate) with the steps/s of the training since the last scoring and the
card's name and power limit; a `vocoder_longrun_halted` line when the
watchdog stops a family.
"""
from __future__ import annotations

import argparse
import copy
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from eval_quality_demo_torch import make_logmel, make_scorer  # noqa: E402

SR = 22050


def _clip(rng: np.random.Generator) -> np.ndarray:
    """One structured environmental-sound clip: 2-4 onsets, each a bell
    (harmonic stack, slow decay) or a drum (noise burst + damped tone); the
    reference bench's generator, draw for draw."""
    n = int(rng.uniform(1.2, 1.8) * SR)
    out = np.zeros(n, np.float32)
    for _ in range(int(rng.integers(2, 5))):
        start = int(rng.uniform(0.0, 0.7) * n)
        dur = min(n - start, int(rng.uniform(0.25, 0.6) * SR))
        t = np.arange(dur) / SR
        f = float(rng.uniform(180.0, 900.0))
        if rng.uniform() < 0.5:  # bell
            env = np.exp(-t * rng.uniform(4.0, 9.0))
            tone = sum(a * np.sin(2 * np.pi * f * h * t)
                       for a, h in ((0.6, 1.0), (0.25, 2.76), (0.15, 5.40)))
        else:  # drum
            env = np.exp(-t * rng.uniform(14.0, 25.0))
            tone = (0.6 * np.sin(2 * np.pi * f * t)
                    + rng.normal(0, 0.3, dur) * np.exp(-t * 60.0))
        out[start:start + dur] += (0.6 * env * tone).astype(np.float32)
    return np.clip(out, -1.0, 1.0)


def corpus_and_gt(device):
    """The 24-clip corpus: 20 train clips and 4 held-out (audio, log-mel
    (n_mels, T)) pairs, each held-out clip cut to whole hops, and the log-mel
    analyser (`eval_quality_demo_torch.make_logmel` at the default audio
    config, the trainer's DSP: 22.05 kHz, n_fft 1024, hop 256, 80 mels to 8
    kHz)."""
    from visual_onoma_to_wave_tpu_torch.config import Config

    audio = Config().audio
    logmel = make_logmel(audio, device)
    rng = np.random.default_rng(0)
    clips = [_clip(rng) for _ in range(24)]
    hop = audio.stft.hop_length
    gt = [(c[: len(c) // hop * hop], logmel(c[: len(c) // hop * hop])) for c in clips[20:]]
    return clips[:20], gt, logmel


def ema_generator(vt):
    """A copy of the trainer's generator holding its EMA parameters."""
    import torch

    gen = copy.deepcopy(vt.gen)
    with torch.no_grad():
        for p, e in zip(gen.parameters(), vt.state.gen_ema):
            p.copy_(e)
    return gen


def card_name(device: str) -> str:
    if not device.startswith("cuda"):
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", default="vocos,hifigan")
    ap.add_argument("--steps", type=int, default=20_000)
    ap.add_argument("--every", type=int, default=2_000)
    ap.add_argument("--ema", type=float, default=0.9999)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--segment-size", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--clip", type=float, default=0.0)
    ap.add_argument("--disc", choices=("msd", "mrd"), default="msd")
    ap.add_argument("--factor", type=float, default=4.0)
    ap.add_argument("--patience", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0,
                    help="the trainer's seed: initial weights and the segment sampler")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from visual_onoma_to_wave_tpu_torch.models.hifigan_disc import MultiResolutionDiscriminator
    from visual_onoma_to_wave_tpu_torch.models.vocoder import get_vocoder
    from visual_onoma_to_wave_tpu_torch.training.vocoder_trainer import (
        VocoderTrainConfig,
        VocoderTrainer,
    )

    cfg = VocoderTrainConfig(total_steps=args.steps, batch_size=args.batch,
                             segment_size=args.segment_size, save_every=10 ** 9, log_every=250,
                             ema_decay=args.ema, on_divergence="halt",
                             divergence_factor=args.factor, divergence_patience=args.patience,
                             learning_rate=args.lr, grad_clip_norm=args.clip,
                             seed=args.seed)
    card = card_name(args.device)
    train_clips, gt, logmel = corpus_and_gt(args.device)
    for family in args.families.split(","):
        vt = VocoderTrainer(train_clips, cfg, gen=get_vocoder(family), device=args.device,
                            msd=MultiResolutionDiscriminator() if args.disc == "mrd" else None)
        t0 = time.perf_counter()
        last = (t0, 0)
        for target in range(args.every, args.steps + 1, args.every):
            vt.train(steps=target)
            if vt.device.type == "cuda":
                torch.cuda.synchronize(vt.device)
            now = time.perf_counter()
            step = vt.state.step
            rate = (step - last[1]) / (now - last[0])
            variants = [("raw", vt.gen)]
            if vt.state.gen_ema is not None:
                variants.append(("ema", ema_generator(vt)))
            for tag, gen in variants:
                print(json.dumps({
                    "metric": "vocoder_longrun_quality", "family": family, "step": step,
                    "iterate": tag, "ema_decay": args.ema, "batch": args.batch,
                    "segment_size": args.segment_size, "lr": args.lr, "clip": args.clip,
                    "disc": args.disc, "seed": args.seed, "train_wall_s": now - t0, "steps_per_s": rate,
                    "device": card,
                    **({"diverged_at": vt.diverged_at} if vt.diverged_at is not None else {}),
                    **make_scorer(gen, gt, logmel, args.device)()}), flush=True)
            last = (time.perf_counter(), step)
            if vt.diverged_at is not None:
                print(json.dumps({"metric": "vocoder_longrun_halted", "family": family,
                                  "diverged_at": vt.diverged_at, "lr": args.lr,
                                  "clip": args.clip}), flush=True)
                break
    return 0


if __name__ == "__main__":
    sys.exit(main())
