#!/usr/bin/env python3
"""Where the device time goes in the port's fused step, ICASSP B16, one GPU.

    python3 tools/profile_torch.py [--vocoder HiFi-GAN|Vocos|iSTFTNet-mel|iSTFTNet|MelGAN]
                                   [--train] [--gan FAMILY] [--out build/profile_torch]

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

With `--train` it profiles the acoustic train step instead (`training/
train_state.train_step`: forward with dropout, loss, backward, clip, Adam),
ICASSP model at B 16 with 8 characters of 28 frames (224 of 256 padded mel
frames, the size of the synthetic corpus's batches), random weights and
targets from seed 0: `train_step_ms` (CUDA events, each of 10 steps after 3
warm-ups) and `profile` over 3 steps, with the classes above plus `optimizer`
(Adam's multi-tensor kernels) and `attention` empty (no kernel runs under
autograd).

With `--gan FAMILY` (hifigan, istftnet-mel, bigvgan, ...) it profiles the
GAN step of `training/vocoder_trainer.py` instead: `chip_smoke.py` phase
17's trainer (the family's recipe and discriminators, B 16 x 8192 samples,
fp32) on `tools/vocoder_longrun_torch.py`'s corpus: `gan_step_ms` (CUDA
events, the period of each of 10 steps after 3 warm-ups, the batch's draw
and copy included) and `profile` over 3 steps with the classes above (cuFFT's
kernels, of the mel loss and the MRD, count as "conv": their names carry
"fft").

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
    if "multi_tensor" in n or "adam" in n:             # the optimizer's foreach kernels
        return "optimizer"
    if "mha_fwd_kernel" in n:
        return "attention"
    if "convnext_kernel" in n:                         # csrc/convnext.cu
        return "convnext"
    if "mrf_" in n:                                    # csrc/mrf.cu (3 kernels)
        return "mrf"
    if any(w in n for w in ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "fft")):
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


def class_table(trace: dict, calls: int) -> tuple[dict, float]:
    """Device ms and launches per call by kernel class, and their total."""
    classes: dict[str, dict] = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "kernel" and "dur" in e:
            c = classes.setdefault(kernel_class(e["name"]), {"ms": 0.0, "launches": 0})
            c["ms"] += e["dur"] / 1e3 / calls
            c["launches"] += 1
    total = sum(c["ms"] for c in classes.values())
    for c in classes.values():
        c["share"] = c["ms"] / total
        c["launches"] //= calls
    return classes, total


def train_batch(dev, model_batch: dict, frames: int = 28, mel_len: int = 256) -> dict:
    """Phase 4's model inputs with targets: `frames` per character, random
    mels and energies from seed 0, mels padded to `mel_len`."""
    g = torch.Generator().manual_seed(0)
    B, C = model_batch["texts"].shape
    valid = torch.arange(C, device=dev)[None, :] < model_batch["src_lens"][:, None]
    return {**model_batch,
            "durations": torch.where(valid, frames, 0).to(torch.int32),
            "mels": torch.randn(B, mel_len, 80, generator=g).to(dev),
            "energies": torch.randn(B, C, generator=g).to(dev)}


def profile_train(dev, out_dir: pathlib.Path) -> None:
    from visual_onoma_to_wave_tpu_torch.training.schedule import NoamAdam
    from visual_onoma_to_wave_tpu_torch.training.train_state import TrainState, train_step

    model, _, batch = chip_smoke.icassp_b16(dev, "MelGAN")
    batch = train_batch(dev, {k: batch[k] for k in ("audiotypes", "texts", "src_lens",
                                                     "image_cells")})
    state = TrainState(model, NoamAdam(model.parameters()),
                       torch.Generator(device=dev).manual_seed(1))
    ms = []
    for i in range(13):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        train_step(state, batch)
        end.record()
        torch.cuda.synchronize()
        if i >= 3:
            ms.append(start.elapsed_time(end))
    print(json.dumps({"train_step_ms": {
        "shape": "ICASSP B16, 8 characters x 28 frames, mels padded to 256",
        "runs": ms, "median": float(np.median(ms))}}), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
    trace_path = out_dir / "train_trace.json"
    prof.export_chrome_trace(str(trace_path))
    (out_dir / "train_kernels.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=80))
    trace = json.loads(trace_path.read_text())
    classes, total = class_table(trace, CALLS)
    print(json.dumps({"profile": {
        "train_steps": CALLS, "wall_ms_per_step": wall_ms, "kernel_ms_per_step": total,
        "classes_per_step": classes, "device": idle_share(trace)}}), flush=True)


def profile_gan(dev, out_dir: pathlib.Path, family: str) -> None:
    vt = chip_smoke.vocoder_trainer(dev, chip_smoke.vocoder_clips(), family)
    chip_smoke.gan_steps(vt, 3)
    ms = chip_smoke.gan_steps(vt, 10)["ms"]
    print(json.dumps({"gan_step_ms": {
        "family": family, "batch": chip_smoke.VOC_B, "segment": chip_smoke.VOC_SEGMENT,
        "disc": type(vt.msd).__name__, "runs": ms, "median": float(np.median(ms))}}),
        flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chip_smoke.gan_steps(vt, CALLS)
        wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
    trace_path = out_dir / f"gan_{family}_trace.json"
    prof.export_chrome_trace(str(trace_path))
    (out_dir / f"gan_{family}_kernels.txt").write_text(
        prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=80))
    trace = json.loads(trace_path.read_text())
    classes, total = class_table(trace, CALLS)
    print(json.dumps({"profile": {
        "gan_steps": CALLS, "wall_ms_per_step": wall_ms, "kernel_ms_per_step": total,
        "classes_per_step": classes, "device": idle_share(trace)}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--vocoder", default="HiFi-GAN",
                    choices=("HiFi-GAN", "Vocos", "iSTFTNet-mel", "iSTFTNet", "MelGAN"))
    ap.add_argument("--train", action="store_true", help="profile the acoustic train step")
    ap.add_argument("--gan", default=None, metavar="FAMILY",
                    help="profile the GAN step of this vocoder family (hifigan, istftnet-mel, ...)")
    ap.add_argument("--out", default=str(ROOT / "build" / "profile_torch"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch: needs an NVIDIA GPU")
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    pin_fp32()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    if args.train:
        print(json.dumps({"card": smi, "train": True}), flush=True)
        profile_train(dev, out_dir)
        return 0
    if args.gan:
        print(json.dumps({"card": smi, "gan": args.gan}), flush=True)
        profile_gan(dev, out_dir, args.gan)
        return 0
    print(json.dumps({"card": smi, "vocoder": args.vocoder}), flush=True)
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
    classes, total = class_table(trace, CALLS)
    ranges = {e.key: getattr(e, "device_time_total", 0) / 1e3 / CALLS
              for e in events if e.key in ("acoustic", "vocoder")}
    print(json.dumps({"profile": {
        "calls": CALLS, "wall_ms_per_call": wall_ms,
        "kernel_ms_per_call": total, "classes_per_call": classes,
        "range_device_ms_per_call": ranges, "device": idle_share(trace)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
