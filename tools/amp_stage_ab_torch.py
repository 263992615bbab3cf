#!/usr/bin/env python3
"""BigVGAN large's AMP stages on the card: the MRF op's "snakebeta_aa" kind
(`ops/mrf.py::mrf_stage_amp`: the one-pass site kernel of `csrc/amp.cu` and
cuDNN bf16 convs) against the plain bf16 modules (three `AMPBlock1`s
averaged, each site six to eight PyTorch ops at 2T), on the same operands,
in turns (plain, op, op, plain) with CUDA events.

    python3 tools/amp_stage_ab_torch.py [--batch 64] [--frames 1000]
        [--parts stages,generator,b2] [--out FILE]

One JSON line per stage shape of the large preset (C 768 ... 24 at T =
frames x the upsampling before the stage): plain and op ms per turn, the op
with cuDNN's autotuner on (`cudnn.benchmark`) beside it, the op's device
time split by a `torch.profiler` pass into the site kernel and the rest
(cuDNN's convs and their layout copies), the stage's bound
(`portbench/reference/bigvgan.py::amp_stage_cost`, the frozen peaks of
`portbench/pbcore/costs.py`) and the op's share of it, the op's gap to its
plain version (`amp_stage_reference`) and to the modules. Then the whole
generator at (batch, frames): the fused path against the plain modules, ms
and peak memory. Weights N(0, 1 / (C k)) (the cell's scale), log alpha and
log beta U(-0.5, 0.5).

`b2`: the conv part of each stage shape against B2's bf16 designs, which
take only C 8-512 in powers of two. At the one or two widths of B2 that
bracket the stage's C (same B and T) the leaky-ReLU stage through
`mrf_route`'s design and through the conv chain, against the stage's 18
convs as the AMP kind runs them on cuDNN (`amp_conv`, no bias, no
activation), in turns; at C itself the 18 cuDNN convs alone, and each B2
design's time estimated there from its ms per C^2 at the brackets
(interpolated in log C; from the one bracket at C 768). Imports
nothing of JAX; needs an NVIDIA GPU. Prints the card's name and power limit
first.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "portbench")]

KS, DS = (3, 7, 11), ((1, 3, 5),) * 3


def time_ms(fn, iters: int = 2) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def randomised(module, seed: int):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if "log_" in name:
                p.copy_(torch.rand(p.shape, generator=g) - 0.5)
            elif name.endswith("weight"):
                fan = p.shape[1] * p.shape[2] if p.dim() == 3 else p.shape[-1]
                p.copy_(torch.randn(p.shape, generator=g) / fan ** 0.5)
            else:
                p.zero_()
    return module


def split_ms(fn) -> dict:
    """Device ms of one call of `fn` by kernel: the site kernel and the rest."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    site = other = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            if "amp_act_kernel" in e.name:
                site += us
            else:
                other += us
    return {"site_kernel_ms": site / 1e3, "rest_ms": other / 1e3}


def b2_bracket(B: int, C: int, T: int, dev) -> dict:
    """B2's bf16 stage at the widths that bracket C against the AMP kind's
    18 cuDNN convs there, and the 18 convs at C (module docstring)."""
    import torch.nn.functional as F

    from visual_onoma_to_wave_tpu_torch.ops import mrf

    g = torch.Generator(device=dev).manual_seed(C)

    def convs18(x, convs):
        for w, k, ds in zip(convs, KS, DS):
            for i, d in enumerate(ds):
                mrf.amp_conv(x, w[2 * i], d)
                F.conv1d(x, w[2 * i + 1], None, padding=(k - 1) // 2)

    def operands(W):
        x = torch.randn(B, W, T, device=dev, generator=g).bfloat16()
        mats = [(torch.randn(6, W, k * W, device=dev, generator=g) * (0.5 / (k * W) ** 0.5))
                for k in KS]
        return x, mats, torch.randn(18, W, 1, device=dev, generator=g) * 0.1

    lo = max(w for w in mrf._WIDTHS if w <= C)
    widths = [lo] + [w for w in mrf._WIDTHS if w > C][:1]
    row = {"b2_bracket_C": C, "T": T, "B": B, "widths": []}
    with torch.inference_mode():
        for W in widths:
            x, mats, bias = operands(W)
            packed = mrf.pack_mrf_kernel_weights(mats, torch.bfloat16)
            convs = mrf.pack_amp_conv_weights(mats, torch.bfloat16)
            runs = {"route": lambda: mrf.mrf_stage_fused(x, *mats, bias, packed=packed),
                    "chain": lambda: mrf._mrf_stage_chain(x, packed, bias, KS, DS),
                    "cudnn18": lambda: convs18(x, convs)}
            t = {name: [] for name in runs}
            for name in (*runs, *reversed(runs)):
                t[name].append(time_ms(runs[name]))
            row["widths"].append({"W": W, "route": mrf.mrf_route(
                W, torch.bfloat16, KS, DS, B, T, mrf.sm_count(dev)),
                **{f"{name}_ms": v for name, v in t.items()}})
            del x, mats, bias, packed, convs
            torch.cuda.empty_cache()
        x, mats, _ = operands(C)
        convs = mrf.pack_amp_conv_weights(mats, torch.bfloat16)
        row["cudnn18_at_C_ms"] = [time_ms(lambda: convs18(x, convs)) for _ in range(2)]
        del x, mats, convs
    cudnn = sum(row["cudnn18_at_C_ms"]) / 2
    for design in ("route", "chain"):
        per = [(w["W"], sum(w[f"{design}_ms"]) / 2 / w["W"] ** 2) for w in row["widths"]]
        if len(per) == 2:
            (w0, p0), (w1, p1) = per
            per_c = p0 + (p1 - p0) * math.log(C / w0) / math.log(w1 / w0)
        else:
            per_c = per[0][1]
        row[f"{design}_est_at_C_ms"] = per_c * C * C
        row[f"{design}_est_over_cudnn18"] = per_c * C * C / cudnn
    torch.cuda.empty_cache()
    return row


def rel_rms(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--parts", default="stages,generator,b2",
                    help="comma-separated: stages, generator, b2")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    want = set(args.parts.split(","))
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 3
    from pbcore import costs
    from visual_onoma_to_wave_tpu_torch.models import get_vocoder
    from visual_onoma_to_wave_tpu_torch.models.bigvgan import BIGVGAN_PRESETS, AMPBlock1
    from visual_onoma_to_wave_tpu_torch.ops import mrf
    from visual_onoma_to_wave_tpu_torch.ops.cuda_build import build_libraries
    from visual_onoma_to_wave_tpu_torch.precision import pin_fp32

    ref = __import__("pbcore.spec", fromlist=["load_module"]).load_module(
        ROOT / "portbench" / "reference" / "bigvgan.py", "pbref_bigvgan")
    pin_fp32()
    build_libraries(("amp", "mrf") if "b2" in want else ("amp",))
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    lines = [{"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}]
    print(json.dumps(lines[0]), flush=True)
    preset = BIGVGAN_PRESETS["large"]
    B, t, ch = args.batch, args.frames, preset["upsample_initial_channel"]
    for i, u in enumerate(preset["upsample_rates"]):
        t *= u
        C = ch // 2 ** (i + 1)
        if "b2" in want:
            row = b2_bracket(B, C, t, dev)
            lines.append(row)
            print(json.dumps(row), flush=True)
        if "stages" not in want:
            continue
        blocks = randomised(torch.nn.ModuleList(
            AMPBlock1(C, k, d, dtype=torch.bfloat16) for k, d in zip(KS, DS)), C).to(dev)
        x = torch.randn(B, C, t, device=dev, generator=torch.Generator(device=dev).manual_seed(i))
        x = x.bfloat16()
        stages = mrf.MRFStages(KS, DS, act="snakebeta_aa")
        with torch.inference_mode():
            def op():
                return stages(0, blocks, x)

            def plain():
                return sum(b(x) for b in blocks) / 3

            times = {"plain": [], "op": [], "op_autotuned": []}
            for name in ("plain", "op", "op", "plain"):
                times[name].append(time_ms(op if name == "op" else plain))
            torch.backends.cudnn.benchmark = True
            times["op_autotuned"] = [time_ms(op), time_ms(op)]
            torch.backends.cudnn.benchmark = False
            parts = split_ms(op)
            got = op()
            small = x[:2, :, : min(t, 8192)].contiguous()
            mats, biases, _, la, lb = stages.packed(0, blocks, torch.bfloat16)
            gap_plain = rel_rms(stages(0, blocks, small),
                                mrf.amp_stage_reference(small, mats, biases, la, lb))
            gap_modules = rel_rms(got, plain())
            del got
        flops, nbytes = ref.amp_stage_cost(B, C, t, "bfloat16")
        bound = costs.bound_s(flops, nbytes, "bfloat16") * 1e3
        op_ms = sum(times["op"]) / 2
        row = {"C": C, "T": t, "B": B, **{k: v for k, v in times.items()},
               "speedup": (sum(times["plain"]) / 2) / op_ms, **parts,
               "bound_ms": bound, "bound_by": "flops" if flops / costs.PEAK_FLOPS["bfloat16"] >
               nbytes / costs.PEAK_BYTES_PER_S else "bytes", "share_of_bound": bound / op_ms,
               "gap_to_plain_version_rel_rms": gap_plain, "gap_to_modules_rel_rms": gap_modules}
        lines.append(row)
        print(json.dumps(row), flush=True)
        del blocks, x, stages
        torch.cuda.empty_cache()
    if "generator" in want:
        gen = randomised(get_vocoder("BigVGAN-large", dtype=torch.bfloat16), 0).to(dev).eval()
        mel = torch.randn(B, args.frames, 80, device=dev) - 4.0
        stages = gen._mrf
        with torch.inference_mode():
            res = {"generator": "BigVGAN-large bf16", "B": B, "frames": args.frames}
            for name in ("fused", "plain", "fused"):
                gen._mrf = stages if name == "fused" else None
                torch.cuda.reset_peak_memory_stats()
                res.setdefault(f"{name}_ms", []).append(time_ms(lambda: gen(mel), iters=1))
                res[f"{name}_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            gen._mrf = stages
            res["fused_over_plain"] = (sum(res["fused_ms"]) / 2) / res["plain_ms"][0]
        lines.append(res)
        print(json.dumps(res), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
