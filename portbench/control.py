#!/usr/bin/env python3
"""Readings for the limits of `correct` (not run by the benchmark's runs).

    python3 portbench/control.py --workload <name> --seeds 1 2 3 [--program]

For each seed: the cell's requests at the cell's own size (the driver's
`control_requests`: for the offline driver the window's first call, every
row), answered by the control, the plain reference in the program's place
computed one precision below what the configuration states
(`pbcore/lowp.py`: TF32 operands for the float32 acoustic model, float8
e4m3 operands with one scale a tensor for the bfloat16 vocoder), and judged
by the float32 reference as a run judges the program. With --program the
port's `Synthesizer` answers the same requests too (the driver's `answer`),
for the lower readings. One JSON line per seed and side.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from pbcore import spec  # noqa: E402


def control_records(ref, reqs) -> list[dict]:
    """The reference `ref` (built with lower-precision roundings) answering
    the requests as the program would: at the served padded text length, its
    own durations and energy buckets, mel and waveform of each request."""
    from pbcore import judge

    out = [None] * len(reqs)
    groups: dict[int, list[int]] = {}
    for i, (r, c) in enumerate(reqs):
        groups.setdefault(c, []).append(i)
    t_max = ref.cfg["acoustic"]["max_mel_len"]
    for c, idx in groups.items():
        for b0 in range(0, len(idx), judge.BLOCK):
            rows = idx[b0:b0 + judge.BLOCK]
            enc = ref.encode([reqs[i][0] for i in rows], c)
            mel_lens = [max(1, min(int(enc["durations"][k].sum()), t_max)) for k in range(len(rows))]
            mels, wavs = ref.decode_and_vocode(enc["x"], enc["bucket"], enc["durations"], mel_lens)
            for k, i in enumerate(rows):
                r, n = reqs[i][0], len(reqs[i][0]["text"])
                out[i] = {"req": r, "C": c, "image": ref.render(r),
                          "durations": enc["durations"][k, :n].cpu().numpy(),
                          "energy": enc["energy"][k, :n].cpu().numpy(),
                          "mel_len": mel_lens[k], "mel": mels[k], "wav": wavs[k]}
    return out


def readings(cell, seed: int, device, program: bool) -> list[dict]:
    import torch

    from pbcore import judge, lowp, program as prog, weights

    cfg, mix = cell.cfg, cell.mix
    fam = cell.families()

    def make_weights():
        return (weights.make(fam["acoustic"].param_specs(cfg["acoustic"], cfg["init"]["acoustic"],
                                                         len(cfg["metadata"]["audiotypes"])),
                             seed, device, 0),
                weights.make(fam["vocoder"].param_specs(cfg["vocoder"], cfg["init"]["vocoder"]),
                             seed, device, 1))

    driver = cell.driver()
    reqs = driver.control_requests(mix, cfg, seed)
    out = []
    if program:
        synth = prog.build(cfg, *make_weights(), device)
        recs = driver.answer(synth, reqs)
        del synth
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = judge.Reference(fam, cfg, *make_weights(), device)
        with torch.no_grad():
            out.append({"side": "program", **judge.judge(ref, recs)})
    ref = judge.Reference(fam, cfg, *make_weights(), device)
    low = judge.Reference(fam, cfg, *make_weights(), device,
                          q_acoustic=lowp.ROUNDINGS[cfg["acoustic"]["dtype"]],
                          q_vocoder=lowp.ROUNDINGS[cfg["vocoder"]["dtype"]])
    with torch.no_grad():
        recs = control_records(low, reqs)
        out.append({"side": "control", **judge.judge(ref, recs)})
    return out


def main(argv=None, device=None, root=ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    import torch

    cell = spec.Cell(args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            print("control.py needs a CUDA device", file=sys.stderr)
            return 3
        device = "cuda"
    for seed in args.seeds:
        for row in readings(cell, seed, torch.device(device), args.program):
            print(json.dumps({"workload": cell.name, "seed": seed, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
