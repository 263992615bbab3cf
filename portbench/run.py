#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA devices
(no device: exit 3, no result). Set-up makes the weights on the card from
`--seed`, builds the configuration's CUDA sources into `build/kernels/`
inside the checkout, builds the port's `Synthesizer`, and warms up every
shape the cell's traffic gives. The window then runs for `--seconds`,
driven by the mix's driver (`drivers/<driver>.py`). Once it has closed and
the device's peak memory is read, the program is freed and the plain
reference (`reference/`) judges the sampled answers (`pbcore/judge.py`).

The last line of standard output is one JSON object: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics, read by `metrics/<name>.py` from a profiler trace of the
window), device, with --trace 1 a breakdown, and last the numbers compared
with their limits, which are also the last lines of standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from pbcore import spec  # noqa: E402

CACHE = ROOT / "build" / "portbench"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own nvcc builds go to build/kernels/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except Exception as e:   # the card's name still comes from torch below
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main(argv=None, device=None, root=ROOT) -> int:
    """Exit code; `device` and `root` are for tests (the CPU, a checkout
    elsewhere): a run from the command line takes CUDA device 0 and its own
    checkout."""
    args = parse(argv)
    cell = spec.Cell(args.workload, root)
    cache_dirs()
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.workload["chips"]:
            print(f"{cell.name} needs {cell.workload['chips']} CUDA device(s); "
                  f"cuda available {torch.cuda.is_available()}, "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    try:
        import visual_onoma_to_wave_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is not in this checkout: {e}", file=sys.stderr)
        return 5
    result, checks, lines = run_cell(cell, args, torch.device(device))
    found = spec.forbidden_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    for line in lines:
        print(line)
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def run_cell(cell, args, device):
    import torch

    from pbcore import judge, program, trace, weights

    cfg, mix, seed = cell.cfg, cell.mix, args.seed
    fam, driver = cell.families(), cell.driver()
    on_card = device.type == "cuda"

    def make_weights():
        return (weights.make(fam["acoustic"].param_specs(cfg["acoustic"], cfg["init"]["acoustic"],
                                                         len(cfg["metadata"]["audiotypes"])),
                             seed, device, 0),
                weights.make(fam["vocoder"].param_specs(cfg["vocoder"], cfg["init"]["vocoder"]),
                             seed, device, 1))

    steps = {"imports": time.perf_counter() - T_START}

    def step(name: str) -> None:
        if on_card:
            torch.cuda.synchronize(device)
        steps[name] = time.perf_counter() - T_START - sum(steps.values())

    if on_card:
        program.build_kernels(cfg)
        step("kernels")
    synth = program.build(cfg, *make_weights(), device)
    step("weights_and_models")
    warm = driver.warm_up(synth, mix, cfg, seed)
    step("warm_up")
    tracer = trace.Tracer(profile=bool(args.trace))
    if args.trace:
        tracer.instrument(synth, cfg)
    step("rest")
    setup_s = time.perf_counter() - T_START
    lines = [f"card: {card()}", f"set-up s: {json.dumps(steps)}; warm-up calls s: "
             f"{json.dumps([round(t, 4) for t in warm])}"]
    tracer.start()
    out = driver.run(synth, mix, cfg, seed, args.seconds)
    summary = tracer.stop()
    lines += out["lines"]
    e2e = dict(out["end_to_end"], setup_s=setup_s)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    ctx = {"cfg": cfg, "mix": mix, "families": fam, "trace": summary, "calls": tracer.calls}
    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"] + cell.bench["per_layer"]}
    if args.trace:
        metrics = {}
        for m in cell.per_layer:
            value = cell.metric_reader(m).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": units[m["name"]]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": [list(x) for x in summary["device_ops"]],
                               "idle_gaps": summary["idle_gaps"]}
        lines.append("traced, device s: " + json.dumps(
            {k: summary[k] for k in ("device_s", "op_calls", "classes")}))

    # the program is freed before the reference runs, so it cannot set the peak
    records = out.pop("records")
    del synth, tracer, out
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = judge.Reference(fam, cfg, *make_weights(), device)
    with torch.no_grad():
        nums = judge.judge(ref, records)
    lines.append(f"reference: {len(records)} requests compared in "
                 f"{time.perf_counter() - t_ref:.2f} s")
    checks = {k: {"value": v, "limit": cfg["limits"][k]} for k, v in nums.items()}
    result["correct"] = bool(result["attempted"] > 0 and result["failed"] == 0 and
                             all(c["value"] <= c["limit"] for c in checks.values()))
    result["checks"] = {k: [c["value"], c["limit"]] for k, c in checks.items()}
    return result, checks, lines


if __name__ == "__main__":
    sys.exit(main())
