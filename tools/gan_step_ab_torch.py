#!/usr/bin/env python3
"""The GAN step with the discriminators' update scoring real and generated
audio one after the other (each sub-discriminator called twice at B, the
reference's formulation) against the port's, which scores them as one batch
of 2B (`models/hifigan_disc.py::_Pair.score`), alternated in one process.

    python3 tools/gan_step_ab_torch.py [--families istftnet-mel,hifigan] [--rounds 2]

For each family (chip_smoke phase 17's trainer: its recipe, B 16 x 8192
samples, fp32, TF32 off) it prints one JSON line: the first step's losses
under each formulation from one initial state and batch, and the median ms of
8 steps after 2 warm-ups, per run, the runs alternated (2B, per-signal,
per-signal, 2B, ...) --rounds times each way; the card's name and power limit.
Imports nothing of JAX; needs an NVIDIA GPU.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def per_signal_score(self, subs, ys, y_hats):
    """`_Pair.score` with every sub-discriminator called on y and on y_hat
    apart, whatever needs a gradient."""
    rs, gs, fr, fg = [], [], [], []
    for d, y, y_hat in zip(subs, ys, y_hats):
        lr, mr = d(y)
        lg, mg = d(y_hat)
        rs.append(lr), gs.append(lg), fr.append(mr), fg.append(mg)
    return rs, gs, fr, fg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--families", default="istftnet-mel,hifigan")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke
    from visual_onoma_to_wave_tpu_torch.models import hifigan_disc
    from visual_onoma_to_wave_tpu_torch.precision import pin_fp32

    if not torch.cuda.is_available():
        raise SystemExit("gan_step_ab_torch: needs an NVIDIA GPU")
    pin_fp32()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    forms = {"2B": hifigan_disc._Pair.score, "per_signal": per_signal_score}
    clips = chip_smoke.vocoder_clips()
    try:
        for family in args.families.split(","):
            first = {}
            for name, score in forms.items():
                hifigan_disc._Pair.score = score
                vt = chip_smoke.vocoder_trainer(dev, clips, family)
                m = vt.train_step(vt._to_device(vt.sampler.next_batch()))
                first[name] = {k: float(v) for k, v in m.items()}
                del vt
            vt = chip_smoke.vocoder_trainer(dev, clips, family)
            runs = {name: [] for name in forms}
            for name in ("2B", "per_signal", "per_signal", "2B") * args.rounds:
                hifigan_disc._Pair.score = forms[name]
                chip_smoke.gan_steps(vt, 2)
                runs[name].append(float(np.median(chip_smoke.gan_steps(vt, 8)["ms"])))
            del vt
            torch.cuda.empty_cache()
            print(json.dumps({"family": family, "card": card, "batch": chip_smoke.VOC_B,
                              "segment": chip_smoke.VOC_SEGMENT, "first_step_losses": first,
                              "step_ms_runs": runs}), flush=True)
    finally:
        hifigan_disc._Pair.score = forms["2B"]
    return 0


if __name__ == "__main__":
    sys.exit(main())
