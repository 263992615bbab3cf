#!/usr/bin/env python3
"""The MRF stage's two bf16 designs side by side on the card, at every width
the one-pass kernel is built for: the one-pass kernel (`ops/mrf.py::
mrf_stage_onepass`) and the conv chain (`_mrf_stage_chain`), on the same
operands, in turns (chain, one-pass, one-pass, chain) with CUDA events.

    python3 tools/mrf_onepass_widths_torch.py [--out FILE]

One JSON line per shape: C, T, B, both designs' ms per turn, whether the two
outputs are bit-equal (the designs sum in one grouping and order), the route
`mrf_route` takes there and the number of one-pass frame tiles (CTAs' work
items) beside the card's SM count. The shapes: B 16 at the served lengths of
a 256x-upsampling generator's last stages (T 128000 at C 64, 256000 below),
and B 2 at short lengths (a few seconds of audio), where the one-pass
kernel's large tiles leave SMs idle. Weights as chip_smoke's
`mrf_weights` makes them. Imports nothing of JAX; needs an NVIDIA GPU. Prints
the card's name and power limit.
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
SHAPES = ((8, 256000, 16), (16, 256000, 16), (32, 256000, 16), (64, 128000, 16),
          (8, 40000, 2), (16, 20000, 2), (32, 10000, 2), (64, 5000, 2))


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


def main(argv=None) -> int:
    from visual_onoma_to_wave_tpu_torch.ops.mrf import (
        _mrf_stage_chain, mrf_route, mrf_stage_onepass, onepass_tile_frames,
        pack_mrf_kernel_weights)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mrf_onepass_widths_torch: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(18)
    lines = []
    with torch.inference_mode():
        for C, T, B in SHAPES:
            mats = [torch.randn(6, C, k * C, generator=gen, device=dev) * (0.5 / (k * C) ** 0.5)
                    for k in KS]
            bias = (torch.randn(18, C, 1, generator=gen, device=dev) * 0.1).contiguous()
            x = torch.randn(B, C, T, generator=gen, device=dev).to(torch.bfloat16)
            packed = pack_mrf_kernel_weights(mats, torch.bfloat16)
            runs = {"chain": lambda: _mrf_stage_chain(x, packed, bias, KS, DS),
                    "onepass": lambda: mrf_stage_onepass(x, packed, bias, KS, DS)}
            equal = bool(torch.equal(runs["chain"](), runs["onepass"]()))
            ms = {n: [] for n in runs}
            for n in ("chain", "onepass", "onepass", "chain"):
                ms[n].append(time_ms(runs[n]))
            line = {"card": card, "C": C, "T": T, "B": B, "ms": ms, "bit_equal": equal,
                    "route": mrf_route(C, torch.bfloat16),
                    "onepass_items": B * -(-T // onepass_tile_frames(C)), "sms": sms}
            print(json.dumps(line), flush=True)
            lines.append(line)
            del x, packed
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            f.writelines(json.dumps(line) + "\n" for line in lines)
    return 0 if all(line["bit_equal"] for line in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
