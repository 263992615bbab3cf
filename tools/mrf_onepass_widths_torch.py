#!/usr/bin/env python3
"""The MRF stage's bf16 designs side by side on the card: the conv chain
(`ops/mrf.py::_mrf_stage_chain`), the one-pass kernel (`mrf_stage_onepass`,
C 8-64) and the unit design (`mrf_stage_unit`, C 64-256), on the same
operands, in turns (chain, then the others, then back) with CUDA events.

    python3 tools/mrf_onepass_widths_torch.py [--out FILE]

One JSON line per shape: C, T, B, each design's ms per turn, whether the
outputs are bit-equal (the designs sum in one grouping and order), the route
`mrf_route` takes for that shape on this card, and each design's work items
(`design_items`: the CTAs' units of work) per SM. The shapes: B 16 at the
served lengths of a 256x-upsampling generator's stages (T 8000 at C 256 ...
256000 at C 8-32), and B 1 and 2 at short lengths, from a quarter of a work
item per SM to a few: the sweep that `MIN_ITEMS_PER_SM`, the route's size
rule, is read from. The last line sums it up: per design and width, the
fewest items per SM from which the design beat the chain at every swept
shape. Weights as chip_smoke's `mrf_weights` makes them. Imports nothing of
JAX; needs an NVIDIA GPU. Prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KS, DS = (3, 7, 11), ((1, 3, 5),) * 3
SERVED = ((8, 256000), (16, 256000), (32, 256000), (64, 128000), (128, 64000), (256, 8000))
# work items per SM of the short shapes (B 1 and 2): the one-pass kernel's
# and the unit design's
SWEEP = {"onepass": (0.25, 0.5, 1.0, 2.0, 4.0), "unit": (0.5, 2.0, 8.0, 16.0, 32.0, 64.0)}


def time_ms(fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def shapes(sms: int) -> list[tuple[int, int, int]]:
    """(C, T, B): the served B 16 stages, then per width the short B 1 / 2
    stages whose items per SM of the width's kernel design sweep SWEEP."""
    from visual_onoma_to_wave_tpu_torch.ops.mrf import onepass_tile_frames, unit_tile_frames

    out = [(C, T, 16) for C, T in SERVED]
    for C, _ in SERVED:
        # the design the width's sweep is for: the one-pass kernel at C <=
        # 32, the unit design above (C 64 takes both: swept for the unit)
        design = "onepass" if C <= 32 else "unit"
        per_item, tile = (1, onepass_tile_frames(C)) if C <= 32 else (3, unit_tile_frames(C))
        for B in (1, 2):
            for share in SWEEP[design]:
                tiles = max(1, round(share * sms / (per_item * B)))
                out.append((C, tiles * tile, B))
    return out


def main(argv=None) -> int:
    from visual_onoma_to_wave_tpu_torch.ops.mrf import (
        _mrf_stage_chain, design_items, mrf_route, mrf_stage_onepass, mrf_stage_unit,
        onepass_takes, pack_mrf_kernel_weights, sm_count, unit_takes)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mrf_onepass_widths_torch: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sms = sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    lines = []
    with torch.inference_mode():
        for C, T, B in shapes(sms):
            mats = [torch.randn(6, C, k * C, generator=gen, device=dev) * (0.5 / (k * C) ** 0.5)
                    for k in KS]
            bias = (torch.randn(18, C, 1, generator=gen, device=dev) * 0.1).contiguous()
            x = torch.randn(B, C, T, generator=gen, device=dev).to(torch.bfloat16)
            packed = pack_mrf_kernel_weights(mats, torch.bfloat16)
            runs = {"chain": lambda: _mrf_stage_chain(x, packed, bias, KS, DS)}
            if onepass_takes(C, torch.bfloat16):
                runs["onepass"] = lambda: mrf_stage_onepass(x, packed, bias, KS, DS)
            if unit_takes(C, torch.bfloat16):
                runs["unit"] = lambda: mrf_stage_unit(x, packed, bias, KS, DS)
            chain = runs["chain"]()
            equal = {n: bool(torch.equal(chain, fn())) for n, fn in runs.items() if n != "chain"}
            iters = 3 if B * T * C * C > 2e10 else 20
            ms = {n: [] for n in runs}
            for order in (list(runs), list(runs)[::-1]):
                for n in order:
                    ms[n].append(time_ms(runs[n], iters))
            line = {"card": card, "C": C, "T": T, "B": B, "ms": ms, "bit_equal": equal,
                    "route": mrf_route(C, torch.bfloat16, KS, DS, B, T, sms), "sms": sms,
                    "items_per_sm": {n: design_items(n, C, B, T) / sms for n in runs
                                     if n != "chain"}}
            print(json.dumps(line), flush=True)
            lines.append(line)
            del x, packed, chain
            torch.cuda.empty_cache()
    # per design and width: the fewest items per SM from which the design
    # was faster than the chain at every measured shape (None: at none)
    threshold = {}
    for line in lines:
        for n, share in line["items_per_sm"].items():
            threshold.setdefault(n, {}).setdefault(line["C"], []).append(
                (share, min(line["ms"][n]) < min(line["ms"]["chain"])))
    summary = {}
    for n, widths in threshold.items():
        for C, cases in widths.items():
            cases.sort()
            wins = [s for i, (s, _) in enumerate(cases) if all(w for _, w in cases[i:])]
            summary.setdefault(n, {})[C] = wins[0] if wins else None
    print(json.dumps({"card": card, "faster_than_chain_from_items_per_sm": summary}), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0 if all(all(line["bit_equal"].values()) for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
