#!/usr/bin/env python3
"""The acoustic quality floor through the PyTorch port: the acoustic half of
`benchmarks/bench_acoustic_floor.py`, with nothing of JAX.

    python3 tools/acoustic_floor_torch.py [--steps 10000] [--n-per-class 60]
        [--batch 16] [--val-step 2000] [--train-seed 0] [--work DIR] [--device cuda]
        [--width {icassp,demo,small}] [--allow-tf32] [--loader-workers N]
        [--threads N] [--mask-device cpu] [--mask-check] [--corpus-device cpu|cuda]
        [--zero-roundoff-grads] [--snapshot-every N]

Builds the port's synthetic corpus (`data/synthetic_corpus.py`, the
examples' generator: 2 classes x --n-per-class clips, seed 0), formats it,
writes its TextGrids and preprocesses it on --corpus-device (default
--device; the mel kernel on the card, its plain fp32 chain on the CPU), then
trains the model of --width (default `icassp`: the ICASSP
geometry, 34.30 M parameters, the default `Config`) at --batch in fp32 with
warm_up_step 400, max_mel_len 512 and seed 0, evaluating with the quality
metrics (teacher-forced mel L1 and MCD, free-running DTW-MCD) every
--val-step steps, to --steps; each validation line also carries how far each
roundoff leaf (below) has moved from its initial value. Prints one JSON line per phase: the corpus,
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

`--mask-device cpu` draws the dropout masks from a CPU generator seeded as the
trainer's (train seed + 1) and moves them to the card: a card run then takes
the CPU run's masks bit for bit and differs from it only in arithmetic.
`--zero-roundoff-grads` (evidence only) sets to exactly zero the gradients
that are zero in exact arithmetic, which the step otherwise computes as
roundoff (`roundoff_leaves`): every attention's key-projection bias (the
softmax is invariant to it) and every bias of a convolution that feeds a
BatchNorm (the batch mean removes it). Adam moves such a leaf by about lr a
step in the direction of its roundoff's sign; with the flag it stays put.

`--snapshot-every N` writes the model's state (parameters and BatchNorm
statistics, fp32 numpy) to `<work>/snapshots/step_<step>.npz` before the
first step and every N steps after it: `tools/trajectory_compare_torch.py`
holds two runs' snapshots against each other.

`--mask-check` instead runs two train steps on the first batch, reads every
dropout mask of both, prints one JSON line of their statistics (each mask's
keep fraction against 1 - p; two same-shape masks of one step, and each mask
against its twin of the next step, agreeing in a fraction against
(1 - p)^2 + p^2, as independent masks do; each as a z-score) and exits 1 when
any lies 5 standard deviations or more from its expectation.
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


def mask_statistics(trainer) -> dict:
    """Two train steps of `trainer` on its first batch, every dropout mask of
    both read; the z-scores of `--mask-check` (module docstring)."""
    import torch

    from visual_onoma_to_wave_tpu_torch.data.dataset import to_device
    from visual_onoma_to_wave_tpu_torch.models.layers import Dropout
    from visual_onoma_to_wave_tpu_torch.training.train_state import train_step

    steps: list[list[tuple[float, torch.Tensor]]] = []
    draw = Dropout.keep_mask

    def recording(self, x):
        keep = draw(self, x)
        steps[-1].append((self.p, keep))
        return keep

    seed = trainer.config.train.seed + 1
    batch = to_device(next(trainer.train_ds.batches(group_size=4, seed=seed)), trainer.device)
    Dropout.keep_mask = recording
    try:
        for _ in range(2):
            steps.append([])
            train_step(trainer.state, batch)
    finally:
        Dropout.keep_mask = draw

    def z_agree(a, b, p):
        n = a.numel()
        e = (1 - p) ** 2 + p ** 2
        return (float((a == b).double().mean()) - e) / (e * (1 - e) / n) ** 0.5

    keep_z = [(float(m.double().mean()) - (1 - p)) / (p * (1 - p) / m.numel()) ** 0.5
              for p, m in steps[0] + steps[1]]
    pair_z = []
    for i, (p, m) in enumerate(steps[0]):
        twin = next(((q, k) for q, k in steps[0][i + 1:] if k.shape == m.shape and q == p), None)
        if twin is not None:
            pair_z.append(z_agree(m, twin[1], p))
    step_z = [z_agree(m, m2, p) for (p, m), (_, m2) in zip(steps[0], steps[1])]
    worst = {k: max(abs(z) for z in v) for k, v in
             (("keep", keep_z), ("same_step_pairs", pair_z), ("consecutive_steps", step_z))}
    return {"metric": "dropout_masks", "generator": str(trainer.state.generator.device),
            "sites_per_step": len(steps[0]),
            "elements_per_step": sum(m.numel() for _, m in steps[0]),
            "n_keep": len(keep_z), "n_same_step_pairs": len(pair_z),
            "n_consecutive_steps": len(step_z),
            **{f"max_abs_z_{k}": v for k, v in worst.items()},
            "ok": bool(len(pair_z) and all(v < 5.0 for v in worst.values()))}


def floor_config(work: pathlib.Path, n_per_class: int = 60, steps: int = 10_000,
                 width: str = "icassp", batch: int = 16):
    """Writes the floor's synthetic corpus under `work` (emptied first) and
    returns (its config, the raw corpus root): the corpus of seed 0, the
    model of `width`, the tool's cadence."""
    from visual_onoma_to_wave_tpu_torch.config import config_from_dict
    from visual_onoma_to_wave_tpu_torch.data.synthetic_corpus import build_corpus, work_config

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    raw_root, ono_root = build_corpus(work, n_per_class)
    cfg_dict = work_config(work, ono_root, steps)
    if WIDTHS[width] is not None:
        cfg_dict["model"] = WIDTHS[width]
    cfg_dict["train"]["optimizer"]["batch_size"] = batch
    # the tool evaluates itself, from the trainer's `on_step` callback
    cfg_dict["train"]["step"].update(val_step=10 ** 9, save_step=steps, synth_step=10 ** 9)
    (work / "cfg.json").write_text(json.dumps(cfg_dict))
    return config_from_dict(cfg_dict), raw_root


def build_floor_corpus(cfg, raw_root, device: str) -> None:
    """Formats the raw corpus, writes its TextGrids and preprocesses it on
    `device` into `cfg.path.preprocessed`."""
    from visual_onoma_to_wave_tpu_torch.data.formatting import format_dataset
    from visual_onoma_to_wave_tpu_torch.data.labels import prepare_textgrids
    from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor

    format_dataset(cfg, raw_root)
    prepare_textgrids(cfg.path.formatted, list(cfg.dataset.extract_labels))
    Preprocessor(cfg, device=device).build(verbose=False)


def roundoff_leaves(model) -> dict:
    """{name: parameter} of the leaves whose gradient is zero in exact
    arithmetic (`--zero-roundoff-grads`): each attention's key-projection
    bias and each bias of a convolution directly followed by a BatchNorm."""
    import torch

    from visual_onoma_to_wave_tpu_torch.models.layers import MultiHeadAttention

    leaves = {}
    for name, m in model.named_modules():
        if isinstance(m, MultiHeadAttention):
            leaves[f"{name}.w_ks.bias"] = m.w_ks.bias
        if isinstance(m, torch.nn.Sequential):
            for i, (a, b) in enumerate(zip(m, list(m)[1:])):
                if isinstance(b, torch.nn.modules.batchnorm._BatchNorm):
                    conv = getattr(a, "conv", a)
                    if getattr(conv, "bias", None) is not None:
                        leaves[f"{name}.{i}.bias"] = conv.bias
    return leaves


def save_snapshot(model, directory: pathlib.Path, step: int) -> pathlib.Path:
    """The model's state dict as fp32 numpy arrays in
    `directory/step_<step>.npz` (`--snapshot-every`)."""
    import numpy as np

    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"step_{step:06d}.npz"
    np.savez(path, **{k: v.detach().float().cpu().numpy()
                      for k, v in model.state_dict().items() if v.is_floating_point()})
    return path


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
    ap.add_argument("--mask-device", choices=("cpu",), default=None,
                    help="draw the dropout masks from a CPU generator (train seed + 1)")
    ap.add_argument("--corpus-device", default=None,
                    help="where the corpus is preprocessed (default: --device)")
    ap.add_argument("--zero-roundoff-grads", action="store_true",
                    help="zero the gradients that are zero in exact arithmetic (evidence only)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="save the model's state every N steps (and at step 0)")
    ap.add_argument("--mask-check", action="store_true",
                    help="print the dropout masks' statistics over two steps and exit")
    args = ap.parse_args(argv)

    make_deterministic()
    import torch

    if args.threads is not None:
        torch.set_num_threads(args.threads)

    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer

    card = card_name() if args.device.startswith("cuda") else "cpu"
    corpus_device = args.corpus_device or args.device
    work = pathlib.Path(args.work)
    t0 = time.perf_counter()
    cfg, raw_root = floor_config(work, args.n_per_class, args.steps, args.width, args.batch)
    build_floor_corpus(cfg, raw_root, corpus_device)
    val_rows = (work / "preprocessed" / "val.txt").read_text().splitlines()
    if not val_rows:
        raise SystemExit(f"the val split is empty (n_per_class={args.n_per_class} holds no "
                         "clip number of dataset.valtest_id)")
    print(json.dumps({"metric": "acoustic_floor_corpus", "device": card,
                      "corpus_device": corpus_device,
                      "prep_s": time.perf_counter() - t0, "val_clips": len(val_rows)}),
          flush=True)

    trainer = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, seed=args.train_seed)),
                      device=args.device, loader_workers=args.loader_workers)
    if args.allow_tf32:     # after the trainer's `pin_fp32`
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    if args.mask_device == "cpu":
        trainer.state.generator = torch.Generator().manual_seed(args.train_seed + 1)
    roundoff_init = {k: p.detach().clone()
                     for k, p in roundoff_leaves(trainer.state.model).items()}
    zeroed = roundoff_leaves(trainer.state.model) if args.zero_roundoff_grads else {}
    for p in zeroed.values():
        p.register_hook(torch.zeros_like)
    print(json.dumps({"metric": "acoustic_floor_modes", "train_seed": args.train_seed,
                      "width": args.width, "allow_tf32": args.allow_tf32,
                      "zeroed_leaves": sorted(zeroed),
                      "mask_device": str(trainer.state.generator.device)}), flush=True)
    if args.mask_check:
        stats = mask_statistics(trainer)
        print(json.dumps(stats), flush=True)
        return 0 if stats["ok"] else 1
    last = {"t": time.perf_counter(), "step": 0}
    logged: list[dict] = []
    snapshots = work / "snapshots"
    if args.snapshot_every:
        save_snapshot(trainer.state.model, snapshots, 0)

    def on_step(step, losses):
        """On a log step, keeps the step's losses (floats there). Every
        --val-step steps: the steps/s since the last validation, the train
        log's means since then, and the validation with the quality metrics,
        as one JSON line."""
        if step % cfg.train.step.log_step == 0:
            logged.append(losses)
        if args.snapshot_every and step % args.snapshot_every == 0:
            save_snapshot(trainer.state.model, snapshots, step)
        if step % args.val_step:
            return
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
        now = time.perf_counter()
        # how far Adam has walked the roundoff leaves from their initial values
        roundoff_drift = {k: float((p.detach() - roundoff_init[k]).abs().max())
                          for k, p in roundoff_leaves(trainer.state.model).items()}
        steps_per_s = (step - last["step"]) / (now - last["t"])
        means = trainer.evaluate(step, metrics=True)
        print(json.dumps({"metric": "acoustic_floor_val", "step": step,
                          "steps_per_s": steps_per_s, **train_log_means(logged),
                          "roundoff_leaf_drift": roundoff_drift, **val_fields(means)}),
              flush=True)
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
