#!/usr/bin/env python3
"""Objective quality of the committed demo checkpoints through the PyTorch
port: the port of `benchmarks/eval_quality_demo.py`, with nothing of JAX.

    python3 tools/eval_quality_demo_torch.py [--device cuda] [--work DIR]
        [--demo examples/checkpoints/demo]

Rebuilds the synthetic demo corpus (`data/synthetic_corpus.py`, 2 classes x
60 clips, seed 0) and runs format -> prepare-tg -> preprocess --save-audio
through the port's CLI on --device (the mel kernel on the card), then pins
the rebuilt `stats.json` against the committed one within 1e-4. It loads
the committed acoustic weights (`torch/acoustic.npz`) into the port's
`Trainer` and reports `evaluate(metrics=True)` over the val split:
teacher-forced mel L1 and MCD, free-running DTW-MCD. It then scores the
three committed vocoders (`torch/vocoder.npz`, `vocoder_istftnet_mel.npz`,
`vocoder_vocos.npz`, each family from its `config*.json`) by
copy-synthesis over the val clips with saved audio: the ground-truth audio,
cut to whole hops, -> log-mel -> `vocoder_infer` -> the first len(audio)
samples clipped to [-1, 1] -> log-mel again, scored in the mel domain (mel
L1, MCD over the common frames) and the waveform domain (multi-resolution
STFT distance), step for step as the reference's `bench_vocoder_quality.py::
make_scorer` and `jit_logmel`.

Prints one JSON line: the acoustic means, `val_items`, `vocoders` (per
committed checkpoint: family, clips, mel_l1, mcd_db, mrstft_sc, mrstft_mag,
mrstft) and `device` (the card's name and power limit as nvidia-smi prints
them, or "cpu"); every value is asserted finite and none is rounded. The
gates it reproduces are BASELINE.md's demo row: acoustic mel L1 1.287 / MCD
67.3 / DTW-MCD 65.9; HiFi-GAN 0.669 / 51.1 / mrstft 2.82; iSTFTNet-mel 1.427
/ 70.5 / 3.94; Vocos 1.264 / 54.1 / 3.69.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import shutil
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

DEMO = ROOT / "examples" / "checkpoints" / "demo"
STATS_TOL = 1e-4
# (tag in the JSON line, committed config, committed port weights)
COMMITTED = (("hifigan", "config.json", "vocoder.npz"),
             ("istftnet_mel", "config_istftnet.json", "vocoder_istftnet_mel.npz"),
             ("vocos", "config_vocos.json", "vocoder_vocos.npz"))


def build_gate_corpus(work: pathlib.Path, device: str, n_per_class: int = 60,
                      demo: pathlib.Path = DEMO) -> dict:
    """The demo corpus under `work` (emptied first), formatted, with its
    TextGrids, preprocessed with --save-audio on `device`, and its
    `stats.json` pinned against the committed one. Returns the config dict
    (the demo model block, paths under `work`)."""
    from visual_onoma_to_wave_tpu_torch.cli import main as cli_main
    from visual_onoma_to_wave_tpu_torch.data.synthetic_corpus import (
        DEMO_MODEL,
        build_corpus,
        work_config,
    )

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    raw_root, ono_root = build_corpus(work, n_per_class)
    cfg_dict = work_config(work, ono_root, steps=1)
    cfg_dict["model"] = DEMO_MODEL
    cfg_path = work / "cfg.json"
    cfg_path.write_text(json.dumps(cfg_dict))
    for argv in (["format", str(cfg_path), str(raw_root)], ["prepare-tg", str(cfg_path)],
                 ["preprocess", str(cfg_path), "--save-audio", "--device", device]):
        cli_main(argv)
    check_stats(demo / "preprocessed" / "stats.json", work / "preprocessed" / "stats.json")
    return cfg_dict


def check_stats(committed_path: pathlib.Path, rebuilt_path: pathlib.Path) -> None:
    """The rebuilt corpus must be the one the checkpoint was trained on:
    every normalisation statistic within `STATS_TOL` of the committed one."""
    committed = json.loads(committed_path.read_text())
    rebuilt = json.loads(rebuilt_path.read_text())
    for k in committed:
        a, b = committed[k], rebuilt[k]
        if any(abs(x - y) > STATS_TOL for x, y in zip(a, b)):
            raise RuntimeError(f"rebuilt corpus stats diverge from the committed ones: {k} "
                               f"{a} vs {b} (the demo generator changed since the checkpoint "
                               "was trained)")


def acoustic_quality(cfg_dict: dict, acoustic: pathlib.Path, device: str) -> dict:
    """`Trainer.evaluate(metrics=True)` of the acoustic weights at `acoustic`
    over the val split, with `val_items`."""
    from visual_onoma_to_wave_tpu_torch.bridge import load_npz, vtts_state_dict
    from visual_onoma_to_wave_tpu_torch.config import config_from_dict
    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer

    cfg = config_from_dict(cfg_dict)
    trainer = Trainer(cfg, device=device)
    trainer.state.model.load_state_dict(vtts_state_dict(load_npz(acoustic)))
    means = trainer.evaluate(metrics=True)
    val = pathlib.Path(cfg.path.preprocessed) / "val.txt"
    means["val_items"] = sum(1 for line in val.read_text().splitlines() if line.strip())
    return means


def make_logmel(audio_cfg, device: str):
    """logmel(wav (samples,) numpy) -> (n_mels, T) numpy: the port's
    `ops/stft.py::logmel_and_energy` on `device`, the counterpart of the
    reference's `jit_logmel`."""
    import numpy as np
    import torch

    from visual_onoma_to_wave_tpu_torch.ops.stft import (
        hann_window,
        logmel_and_energy,
        melscale_fbanks,
    )

    st, mel = audio_cfg.stft, audio_cfg.mel
    window = torch.from_numpy(hann_window(st.win_length)).to(device)
    fb = torch.from_numpy(melscale_fbanks(st.filter_length // 2 + 1, mel.mel_fmin, mel.mel_fmax,
                                          mel.n_mel_channels, audio_cfg.sampling_rate)).to(device)

    def logmel(wav) -> np.ndarray:
        with torch.no_grad():
            m, _ = logmel_and_energy(torch.from_numpy(np.asarray(wav, np.float32))[None]
                                     .to(device), window, fb, st.filter_length,
                                     st.hop_length, st.win_length)
        return m[0].cpu().numpy()
    return logmel


def ground_truth(preprocessed: pathlib.Path, hop: int, logmel) -> list:
    """(audio, log-mel (n_mels, T)) of each val clip with saved audio, the
    audio cut to a whole number of hops so that the vocoded length equals
    the clip's."""
    import numpy as np

    gt = []
    for line in (preprocessed / "val.txt").read_text().splitlines():
        if not line.strip():
            continue
        name, label = line.split("|")[:2]
        p = preprocessed / "audio" / label / f"{name}.npy"
        if not p.exists():
            continue
        wav = np.asarray(np.load(p), np.float32)
        wav = wav[: len(wav) // hop * hop]
        gt.append((wav, logmel(wav)))
    if not gt:
        raise RuntimeError("no val clips with saved audio (preprocess --save-audio?)")
    return gt


def make_scorer(gen, gt: list, logmel, device: str):
    """score() -> copy-synthesis quality of `gen` over the `gt` pairs: mel L1
    and MCD of the re-analysed waveform against the ground-truth mel over
    their common frames, and the multi-resolution STFT distance to the
    ground-truth audio; means over the clips, unrounded."""
    import numpy as np
    import torch

    from visual_onoma_to_wave_tpu_torch.metrics import mcd_frames, mel_l1, mrstft_distance
    from visual_onoma_to_wave_tpu_torch.models.vocoder import vocoder_infer

    gen = gen.to(device).eval()

    def score() -> dict:
        l1s, mcds, scs, mags = [], [], [], []
        for audio, mel in gt:
            with torch.no_grad():
                wav = vocoder_infer(gen, torch.from_numpy(np.ascontiguousarray(mel.T))[None]
                                    .to(device))[0]
            wav = np.clip(wav[0].cpu().numpy()[: len(audio)], -1.0, 1.0)
            mel2 = logmel(wav)
            t = min(mel.shape[1], mel2.shape[1])
            l1s.append(mel_l1(mel2[:, :t].T, mel[:, :t].T))
            mcds.append(mcd_frames(mel2[:, :t].T, mel[:, :t].T))
            d = mrstft_distance(wav, audio)
            scs.append(d["sc"])
            mags.append(d["mag"])
        return {"mel_l1": float(np.mean(l1s)), "mcd_db": float(np.mean(mcds)),
                "mrstft_sc": float(np.mean(scs)), "mrstft_mag": float(np.mean(mags)),
                "mrstft": float(np.mean(scs) + np.mean(mags))}
    return score


def committed_vocoders(demo: pathlib.Path = DEMO) -> list:
    """(tag, family, generator with its weights) of each committed vocoder."""
    from visual_onoma_to_wave_tpu_torch.bridge import load_npz, vocoder_state_dict
    from visual_onoma_to_wave_tpu_torch.models.vocoder import get_vocoder

    out = []
    for tag, cfg_file, weights in COMMITTED:
        model_blk = json.loads((demo / cfg_file).read_text())["model"]
        family = model_blk.get("vocoder_model") or "HiFi-GAN"
        gen = get_vocoder(family, **dict(model_blk.get("vocoder_kwargs") or {}))
        gen.load_state_dict(vocoder_state_dict(family, load_npz(demo / "torch" / weights)))
        out.append((tag, family, gen))
    return out


def score_committed_vocoders(demo: pathlib.Path, preprocessed: pathlib.Path, audio_cfg,
                             device: str) -> dict:
    """Copy-synthesis quality of each committed vocoder over the val clips
    with saved audio: {tag: {family, clips, mel_l1, mcd_db, mrstft_sc,
    mrstft_mag, mrstft}}."""
    logmel = make_logmel(audio_cfg, device)
    gt = ground_truth(preprocessed, audio_cfg.stft.hop_length, logmel)
    return {tag: {"family": family, "clips": len(gt), **make_scorer(gen, gt, logmel, device)()}
            for tag, family, gen in committed_vocoders(demo)}


def assert_finite(v, path: str = "") -> None:
    """Every float in the nested result is finite."""
    if isinstance(v, dict):
        for k, x in v.items():
            assert_finite(x, f"{path}.{k}")
    elif isinstance(v, float):
        assert math.isfinite(v), f"non-finite metric at {path}: {v}"


def run_gate(work: pathlib.Path, device: str, demo: pathlib.Path = DEMO) -> dict:
    """The whole gate: corpus, acoustic means, the three vocoders."""
    from visual_onoma_to_wave_tpu_torch.config import config_from_dict

    cfg_dict = build_gate_corpus(work, device, demo=demo)
    means = acoustic_quality(cfg_dict, demo / "torch" / "acoustic.npz", device)
    means["vocoders"] = score_committed_vocoders(
        demo, work / "preprocessed", config_from_dict(cfg_dict).audio, device)
    assert_finite(means)
    return means


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when no GPU is visible")
    ap.add_argument("--work", default=str(ROOT / "build" / "demo_quality"))
    ap.add_argument("--demo", default=str(DEMO))
    args = ap.parse_args(argv)
    means = run_gate(pathlib.Path(args.work), args.device, pathlib.Path(args.demo))
    sys.path.insert(0, str(ROOT / "tools"))
    from acoustic_floor_torch import card_name

    print(json.dumps({**means, "device": card_name() if args.device.startswith("cuda")
                      else "cpu"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
