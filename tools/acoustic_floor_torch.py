#!/usr/bin/env python3
"""The acoustic quality floor through the PyTorch port: the acoustic half of
`benchmarks/bench_acoustic_floor.py`, with nothing of JAX.

    python3 tools/acoustic_floor_torch.py [--steps 10000] [--n-per-class 60]
        [--batch 16] [--val-step 2000] [--train-seed 0] [--work DIR] [--device cuda]
        [--width {icassp,demo,small}] [--allow-tf32] [--loader-workers N]
        [--threads N]

Builds the port's synthetic corpus (`data/synthetic_corpus.py`, the
examples' generator: 2 classes x --n-per-class clips, seed 0), formats it,
writes its TextGrids and preprocesses it on --device (the mel kernel on the
card), then trains the model of --width (default `icassp`: the ICASSP
geometry, 34.30 M parameters, the default `Config`) at --batch in fp32 with
warm_up_step 400, max_mel_len 512 and seed 0, evaluating with the quality
metrics (teacher-forced mel L1 and MCD, free-running DTW-MCD) every
--val-step steps, to --steps. Prints one JSON line per phase: the corpus,
each validation (the trajectory, with the
steps/s since the last one, the validation losses as `val_*`, and the means
of the train losses logged since the last validation as `train_*` with the
mean and max pre-clip gradient norm), and the final metrics with the
training wall time and the card's name and power limit.

The run is deterministic: before CUDA is first touched the tool sets
`CUBLAS_WORKSPACE_CONFIG=:4096:8`, cuDNN's deterministic mode (no benchmark
search) and `torch.use_deterministic_algorithms(True)`, so that one seed
gives one trajectory. `--allow-tf32` lets matmuls and cuDNN convolutions take
TF32 (the trainer pins IEEE fp32 on the card otherwise): evidence only.

`--train-seed` seeds the training alone (initial weights, dropout, batch
order) while the corpus and its val split stay those of seed 0. `--width
demo` trains the demo checkpoint's geometry (`data/synthetic_corpus.py::
DEMO_MODEL`: hidden 128, 2 + 2 FFT layers, 3.98 M parameters), a width the
CPU trains; `--width small` (alias `--small`) a model of one layer each and
hidden 32 (a CPU rehearsal of the tool, not a floor).
The work directory (default `build/acoustic_floor/`) is emptied first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from visual_onoma_to_wave_tpu_torch.data.synthetic_corpus import DEMO_MODEL  # noqa: E402

# the rehearsal model of --width small
SMALL_MODEL = {
    "transformer": {"encoder_layer": 1, "decoder_layer": 1, "encoder_hidden": 32,
                    "decoder_hidden": 32, "conv_filter_size": 64, "conv_kernel_size": [3, 1]},
    "visual_feature_extractor": {"layer_num": 1},
    "variance_predictor": {"filter_size": 32},
    "max_seq_len": 128, "postnet_channels": 32,
}


# the model block of each --width (None: the default `Config`, the ICASSP geometry)
WIDTHS = {"icassp": None, "demo": DEMO_MODEL, "small": SMALL_MODEL}

# what each validation line reports of the train log since the last one
TRAIN_LOSS_KEYS = ("total_loss", "mel_loss", "postnet_mel_loss", "duration_loss",
                   "energy_loss", "kurtosis_loss")


def make_deterministic() -> None:
    """cuBLAS, cuDNN and torch's own ops in their deterministic modes; call
    before CUDA is first touched (cuBLAS reads its workspace setting when its
    first handle is made)."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)


def train_log_means(logged: list[dict]) -> dict:
    """The means of the train losses over the log steps in `logged`, and the
    mean and max of their pre-clip gradient norms, as `train_*` fields."""
    out = {f"train_{k}": float(sum(d[k] for d in logged) / len(logged))
           for k in TRAIN_LOSS_KEYS if logged and k in logged[0]}
    norms = [d["grad_norm"] for d in logged]
    out.update(train_log_steps=len(logged),
               train_grad_norm_mean=float(sum(norms) / len(norms)) if norms else None,
               train_grad_norm_max=float(max(norms)) if norms else None)
    return out


def val_fields(means: dict) -> dict:
    """`Trainer.evaluate`'s means with its losses renamed `val_*` (the
    quality metrics keep their names)."""
    from visual_onoma_to_wave_tpu_torch.training.trainer import LOSS_KEYS

    return {(f"val_{k}" if k in LOSS_KEYS else k): v for k, v in means.items()}


def card_name() -> str:
    """`nvidia-smi`'s name and power limit of the card, or "cpu"."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=10_000)
    ap.add_argument("--n-per-class", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--val-step", type=int, default=2000)
    ap.add_argument("--train-seed", type=int, default=0)
    ap.add_argument("--work", default=str(ROOT / "build" / "acoustic_floor"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", choices=tuple(WIDTHS), default="icassp")
    ap.add_argument("--small", dest="width", action="store_const", const="small",
                    help="alias of --width small")
    ap.add_argument("--loader-workers", type=int, default=None,
                    help="batch-loader worker processes (the trainer's default without it)")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch's intra-op threads (for runs side by side on the CPU)")
    ap.add_argument("--allow-tf32", action="store_true",
                    help="let matmuls and cuDNN convs take TF32 (evidence only)")
    args = ap.parse_args(argv)

    make_deterministic()
    import torch

    if args.threads is not None:
        torch.set_num_threads(args.threads)

    from visual_onoma_to_wave_tpu_torch.config import config_from_dict
    from visual_onoma_to_wave_tpu_torch.data.formatting import format_dataset
    from visual_onoma_to_wave_tpu_torch.data.labels import prepare_textgrids
    from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor
    from visual_onoma_to_wave_tpu_torch.data.synthetic_corpus import build_corpus, work_config
    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer

    card = card_name() if args.device.startswith("cuda") else "cpu"
    work = pathlib.Path(args.work)
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    raw_root, ono_root = build_corpus(work, args.n_per_class)
    cfg_dict = work_config(work, ono_root, args.steps)
    if WIDTHS[args.width] is not None:
        cfg_dict["model"] = WIDTHS[args.width]
    cfg_dict["train"]["optimizer"]["batch_size"] = args.batch
    # the tool evaluates itself, from the trainer's `on_step` callback
    cfg_dict["train"]["step"].update(val_step=10 ** 9, save_step=args.steps,
                                     synth_step=10 ** 9)
    (work / "cfg.json").write_text(json.dumps(cfg_dict))
    cfg = config_from_dict(cfg_dict)
    format_dataset(cfg, raw_root)
    prepare_textgrids(cfg.path.formatted, list(cfg.dataset.extract_labels))
    Preprocessor(cfg, device=args.device).build(verbose=False)
    val_rows = (work / "preprocessed" / "val.txt").read_text().splitlines()
    if not val_rows:
        raise SystemExit(f"the val split is empty (n_per_class={args.n_per_class} holds no "
                         "clip number of dataset.valtest_id)")
    print(json.dumps({"metric": "acoustic_floor_corpus", "device": card,
                      "prep_s": time.perf_counter() - t0, "val_clips": len(val_rows)}),
          flush=True)

    trainer = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, seed=args.train_seed)),
                      device=args.device, loader_workers=args.loader_workers)
    if args.allow_tf32:     # after the trainer's `pin_fp32`
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    print(json.dumps({"metric": "acoustic_floor_modes", "train_seed": args.train_seed,
                      "width": args.width, "allow_tf32": args.allow_tf32}), flush=True)
    last = {"t": time.perf_counter(), "step": 0}
    logged: list[dict] = []

    def on_step(step, losses):
        """On a log step, keeps the step's losses (floats there). Every
        --val-step steps: the steps/s since the last validation, the train
        log's means since then, and the validation with the quality metrics,
        as one JSON line."""
        if step % cfg.train.step.log_step == 0:
            logged.append(losses)
        if step % args.val_step:
            return
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        now = time.perf_counter()
        steps_per_s = (step - last["step"]) / (now - last["t"])
        means = trainer.evaluate(step, metrics=True)
        print(json.dumps({"metric": "acoustic_floor_val", "step": step,
                          "steps_per_s": steps_per_s, **train_log_means(logged),
                          **val_fields(means)}), flush=True)
        logged.clear()
        last.update(t=time.perf_counter(), step=step)

    t0 = time.perf_counter()
    trainer.train(max_steps=args.steps, on_step=on_step)
    train_s = time.perf_counter() - t0
    means = trainer.evaluate(metrics=True)
    print(json.dumps({"metric": "acoustic_floor_quality", "device": card, "steps": args.steps,
                      "train_seed": args.train_seed, "width": args.width,
                      "batch": args.batch, "n_params": trainer.n_params(),
                      "train_wall_s": train_s, "steps_per_s": args.steps / train_s,
                      "allow_tf32": args.allow_tf32, **val_fields(means)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
