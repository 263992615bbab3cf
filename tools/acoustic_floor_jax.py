#!/usr/bin/env python3
"""The acoustic quality floor through the JAX package, with a seed and a
width: the reference side of `tools/acoustic_floor_torch.py`, for comparing
the two packages' spread over seeds on the CPU.

    python3 tools/acoustic_floor_jax.py [--steps 10000] [--n-per-class 60]
        [--batch 16] [--val-step 1000] [--train-seed 0] [--width demo]
        [--work DIR]

Builds the examples' synthetic corpus (`examples/train_demo_artifacts.py::
build_corpus`: 2 classes x --n-per-class clips, seed 0), formats it, writes
its TextGrids and preprocesses it through the JAX package's CLI, then trains
`visual_onoma_to_wave_tpu/training/trainer.py::Trainer` (no mesh) at --batch
with warm_up_step 400, max_mel_len 512 and --train-seed, evaluating with the
quality metrics every --val-step steps, to --steps. `--width demo` is the
demo checkpoint's geometry (`DEMO_MODEL`), `icassp` the default `Config`.
Prints the port tool's JSON lines: the corpus, each validation (steps/s
since the last one, the val losses as `val_*`, the train log's means since
then as `train_*` with the pre-clip gradient norm's mean and max) and the
final metrics. `benchmarks/bench_acoustic_floor.py` is the fixed-seed,
full-width floor; this tool is not part of the port and imports JAX. On a
shared CPU cap its threads first, e.g. `XLA_FLAGS=--xla_cpu_multi_thread_eigen=false
taskset -c 0 python3 tools/acoustic_floor_jax.py ...`.
The work directory (default `build/acoustic_floor_jax/`) is emptied first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import shutil
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT / "tools"))

from acoustic_floor_torch import train_log_means  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10_000)
    ap.add_argument("--n-per-class", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--val-step", type=int, default=1000)
    ap.add_argument("--train-seed", type=int, default=0)
    ap.add_argument("--width", choices=("demo", "icassp"), default="demo")
    ap.add_argument("--work", default=str(ROOT / "build" / "acoustic_floor_jax"))
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from train_demo_artifacts import build_corpus, work_config

    from visual_onoma_to_wave_tpu.cli import main as cli_main
    from visual_onoma_to_wave_tpu.config import config_from_dict
    from visual_onoma_to_wave_tpu.training.trainer import LOSS_KEYS, Trainer

    work = pathlib.Path(args.work)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    raw_root, ono_root = build_corpus(work, args.n_per_class)
    cfg_dict = work_config(work, ono_root, args.steps)   # its model block is DEMO_MODEL
    if args.width == "icassp":
        del cfg_dict["model"]
    cfg_dict["train"]["optimizer"]["batch_size"] = args.batch
    cfg_dict["train"]["step"].update(val_step=10 ** 9, save_step=args.steps,
                                     synth_step=10 ** 9)
    cfg_path = work / "cfg.json"
    cfg_path.write_text(json.dumps(cfg_dict))
    for cmd in (["format", str(cfg_path), str(raw_root)], ["prepare-tg", str(cfg_path)],
                ["preprocess", str(cfg_path)]):
        if cli_main(cmd) not in (0, None):
            raise RuntimeError(f"cli {cmd[0]} failed")
    val_rows = (work / "preprocessed" / "val.txt").read_text().splitlines()
    if not val_rows:
        raise SystemExit(f"the val split is empty (n_per_class={args.n_per_class})")
    print(json.dumps({"metric": "acoustic_floor_corpus", "device": "cpu", "package": "jax",
                      "prep_s": time.perf_counter() - t0, "val_clips": len(val_rows)}),
          flush=True)

    cfg = config_from_dict(cfg_dict)
    trainer = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, seed=args.train_seed)),
                      use_mesh=False)

    def val_fields(means: dict) -> dict:
        return {(f"val_{k}" if k in LOSS_KEYS else k): v for k, v in means.items()}

    print(json.dumps({"metric": "acoustic_floor_modes", "package": "jax",
                      "train_seed": args.train_seed, "width": args.width}), flush=True)
    last = {"t": time.perf_counter(), "step": 0}
    logged: list[dict] = []

    def on_step(step, losses):
        """As the port tool's: the log steps' losses kept, and every
        --val-step steps one validation line with the quality metrics."""
        if step % cfg.train.step.log_step == 0:
            logged.append(losses)
        if step % args.val_step:
            return
        now = time.perf_counter()
        steps_per_s = (step - last["step"]) / (now - last["t"])
        means = trainer.evaluate(step, metrics=True)
        print(json.dumps({"metric": "acoustic_floor_val", "package": "jax", "step": step,
                          "steps_per_s": steps_per_s, **train_log_means(logged),
                          **val_fields(means)}), flush=True)
        logged.clear()
        last.update(t=time.perf_counter(), step=step)

    t0 = time.perf_counter()
    try:
        trainer.train(max_steps=args.steps, on_step=on_step)
        train_s = time.perf_counter() - t0
        means = trainer.evaluate(metrics=True)
    finally:
        trainer.ckpt.close()
    print(json.dumps({"metric": "acoustic_floor_quality", "package": "jax", "device": "cpu",
                      "steps": args.steps, "train_seed": args.train_seed, "width": args.width,
                      "batch": args.batch, "n_params": trainer.n_params(),
                      "train_wall_s": train_s, "steps_per_s": args.steps / train_s,
                      **val_fields(means)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
