#!/usr/bin/env python3
"""Where the device time goes in the port's fused step, ICASSP B16, one GPU.

    python3 tools/profile_torch.py [--vocoder HiFi-GAN|Vocos|iSTFTNet-mel|iSTFTNet|MelGAN]
                                   [--out build/profile_torch]

Builds the model, vocoder and batch of `chip_smoke.py` phase 4 (ICASSP
configuration + HiFi-GAN V1, random weights from seed 0, 16 requests) or,
with `--vocoder`, of phases 6, 10 and 11 (the same acoustic model and batch
with the published mel-Vocos, iSTFTNet-mel, iSTFTNet C8C8I or MelGAN), and
prints, one JSON object per line:

  * `card`: the card and its power limit (nvidia-smi);
  * `acoustic_ab`: the acoustic forward with the attention kernel against
    the same forward with the plain PyTorch attention, alternated
    (kernel, plain, plain, kernel, ...) 6 runs each, CUDA events;
  * `profile`: torch.profiler over 3 fused calls after 2 warm-ups:
    wall ms per call, device time per kernel class (conv, elementwise,
    attention, convnext, gemm, other), device time inside the `acoustic` and
    `vocoder` ranges, and the device idle share (1 - union of the kernel
    and copy intervals / their span).

The full kernel table and the Chrome trace go to `--out`. Imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
PAIRS, CALLS = 3, 3   # alternated (kernel, plain) pairs, each way; profiled calls

import chip_smoke  # noqa: E402
from visual_onoma_to_wave_tpu_torch.models import layers  # noqa: E402
from visual_onoma_to_wave_tpu_torch.ops import attention  # noqa: E402
from visual_onoma_to_wave_tpu_torch.precision import pin_fp32  # noqa: E402


def kernel_class(name: str) -> str:
    n = name.lower()
    if "mha_fwd_kernel" in n:
        return "attention"
    if "convnext_kernel" in n:                         # csrc/convnext.cu
        return "convnext"
    if "mrf_" in n:                                    # csrc/mrf.cu (3 kernels)
        return "mrf"
    if any(w in n for w in ("conv", "fprop", "dgrad", "implicit", "winograd", "fft")):
        return "conv"
    if "gemm" in n or "gemv" in n:
        return "gemm"
    if any(w in n for w in ("elementwise", "vectorized", "reduce", "copy", "fill", "index",
                            "where", "cat")):
        return "elementwise"
    return "other"


def idle_share(trace: dict) -> dict:
    """Device busy/idle from the Chrome trace's kernel, memcpy and memset events."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    busy, end = 0.0, -np.inf
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    span = spans[-1][1] - spans[0][0] if spans else 0.0
    return {"events": len(spans), "busy_ms": busy / 1e3, "span_ms": span / 1e3,
            "idle_share": 1.0 - busy / span if span else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vocoder", default="HiFi-GAN",
                    choices=("HiFi-GAN", "Vocos", "iSTFTNet-mel", "iSTFTNet", "MelGAN"))
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_torch"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs an NVIDIA GPU")
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    pin_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": smi, "vocoder": args.vocoder}), flush=True)

    dev = torch.device("cuda", 0)
    model, gen, batch = chip_smoke.icassp_b16(dev, args.vocoder)

    def acoustic():
        return model(batch["audiotypes"], batch["texts"], batch["src_lens"],
                     image_cells=batch["image_cells"])

    def fused():
        with record_function("acoustic"):
            mel = acoustic()["postnet_mel"]
        with record_function("vocoder"):
            return gen(mel)

    cores = {"kernel": attention.attention_core, "plain": attention.attention_core_reference}
    runs = {"kernel": [], "plain": []}
    with torch.inference_mode():
        for order in (("kernel", "plain"), ("plain", "kernel")) * PAIRS:
            for name in order:
                layers.attention_core = cores[name]
                runs[name].append(chip_smoke.time_cuda(acoustic, 10, warmup=2))
        layers.attention_core = attention.attention_core
        print(json.dumps({"acoustic_ab": {
            "shape": "ICASSP B16, acoustic forward, ms per call (CUDA events, 10 calls per run)",
            "kernel_ms_runs": runs["kernel"], "plain_ms_runs": runs["plain"],
            "kernel_median_ms": float(np.median(runs["kernel"])),
            "plain_median_ms": float(np.median(runs["plain"])),
            "every_kernel_run_faster": max(runs["kernel"]) < min(runs["plain"])}}), flush=True)

        for _ in range(2):
            fused()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fused()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS

    trace_path = out_dir / "fused_trace.json"
    prof.export_chrome_trace(str(trace_path))
    events = prof.key_averages()
    (out_dir / "kernels.txt").write_text(events.table(sort_by="self_cuda_time_total",
                                                       row_limit=80))
    trace = json.loads(trace_path.read_text())
    classes: dict[str, dict] = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "kernel" and "dur" in e:
            c = classes.setdefault(kernel_class(e["name"]), {"ms": 0.0, "launches": 0})
            c["ms"] += e["dur"] / 1e3 / CALLS
            c["launches"] += 1
    total = sum(c["ms"] for c in classes.values())
    for c in classes.values():
        c["share"] = c["ms"] / total
        c["launches"] //= CALLS
    ranges = {e.key: getattr(e, "device_time_total", 0) / 1e3 / CALLS
              for e in events if e.key in ("acoustic", "vocoder")}
    print(json.dumps({"profile": {
        "calls": CALLS, "wall_ms_per_call": wall_ms,
        "kernel_ms_per_call": total, "classes_per_call": classes,
        "range_device_ms_per_call": ranges, "device": idle_share(trace)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
