#!/usr/bin/env python3
"""One acoustic train step on the card against the same step on its CPU,
module by module.

    python3 tools/step_compare_torch.py [--width demo] [--train-seed 0]
        [--train-steps 0,3000] [--n-per-class 60] [--work DIR] [--threshold 1e-4]
        [--device cuda]

Builds the floor corpus of `tools/acoustic_floor_torch.py` on the CPU (so
both sides read the same arrays) and its trainer on the card, deterministic,
with the dropout masks drawn from a CPU generator (`--mask-device cpu`).
At each count of `--train-steps` (the card trains to it first), the model,
its BatchNorm statistics and the generator's state are copied to a card
replica and a CPU replica, and each takes one train step
(`training/train_state.py::train_step`) on the same batch (the first of
epoch 1's plan) with the same masks. Forward hooks record every module's
output (each call, in execution order) and tensor hooks every parameter's
gradient. Prints one JSON line per count: the losses on both sides, the
first module in execution order whose output's relative difference
(max |card - cpu| / max |cpu|) exceeds --threshold, and the modules and
gradients of largest relative difference. fp32 with TF32 off differs from
the CPU by summation order alone, ~1e-6 relative.
"""
from __future__ import annotations

import argparse
import copy
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from acoustic_floor_torch import (  # noqa: E402
    build_floor_corpus,
    card_name,
    floor_config,
    make_deterministic,
)


def _tensors(out) -> list:
    import torch

    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


def record_step(state, batch) -> dict:
    """One `train_step` of `state` on `batch` with every module's output
    and every parameter's gradient recorded (float64 on the host)."""
    import torch

    from visual_onoma_to_wave_tpu_torch.training.train_state import train_step

    outputs: list[tuple[str, torch.Tensor]] = []
    grads: dict[str, torch.Tensor] = {}
    calls: dict[str, int] = {}
    handles = []
    for name, module in state.model.named_modules():
        def hook(mod, args, out, name=name or "model"):
            ts = _tensors(out)
            if not ts:
                return
            i = calls.get(name, 0)
            calls[name] = i + 1
            flat = torch.cat([t.detach().reshape(-1).double().cpu() for t in ts])
            outputs.append((f"{name}#{i}", flat))
        handles.append(module.register_forward_hook(hook))
    for name, p in state.model.named_parameters():
        handles.append(p.register_hook(
            lambda g, name=name: grads.__setitem__(name, g.detach().double().cpu())))
    try:
        losses = train_step(state, batch)
    finally:
        for h in handles:
            h.remove()
    return {"losses": {k: float(v) for k, v in losses.items()}, "outputs": outputs,
            "grads": grads}


def rel_diff(a, b) -> float:
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / scale if scale > 0 else float((a - b).abs().max())


def compare(trainer, batch, generator_state, threshold: float) -> dict:
    import torch

    from visual_onoma_to_wave_tpu_torch.data.dataset import to_device
    from visual_onoma_to_wave_tpu_torch.training.schedule import NoamAdam
    from visual_onoma_to_wave_tpu_torch.training.train_state import TrainState

    opt = trainer.config.train.optimizer
    sides = {}
    for where in (trainer.device, torch.device("cpu")):
        model = copy.deepcopy(trainer.state.model).to(where)
        gen = torch.Generator()
        gen.set_state(generator_state)
        state = TrainState(model, NoamAdam(model.parameters(), init_lr=opt.init_lr,
                                           warmup_steps=opt.warm_up_step,
                                           grad_clip=opt.grad_clip_thresh), gen)
        sides[where.type] = record_step(state, to_device(batch, where))
        del model, state
    card, cpu = sides[trainer.device.type], sides["cpu"]
    names = [n for n, _ in cpu["outputs"]]
    if names != [n for n, _ in card["outputs"]]:
        raise AssertionError("the two sides ran different module sequences")
    out_rel = [(n, rel_diff(a, b)) for (n, a), (_, b) in zip(card["outputs"], cpu["outputs"])]
    grad_rel = [(n, rel_diff(card["grads"][n], g)) for n, g in cpu["grads"].items()]
    first = next(((i, n, r) for i, (n, r) in enumerate(out_rel) if r > threshold), None)
    return {"losses_card": card["losses"], "losses_cpu": cpu["losses"],
            "modules": len(out_rel), "threshold": threshold,
            "first_above": (None if first is None else
                            {"order": first[0], "module": first[1], "rel": first[2],
                             "before": out_rel[max(0, first[0] - 3):first[0]]}),
            "max_output_rel": max(r for _, r in out_rel),
            "top_outputs": sorted(out_rel, key=lambda t: -t[1])[:15],
            "execution_order_first_20": out_rel[:20],
            "max_grad_rel": max(r for _, r in grad_rel),
            "top_grads": sorted(grad_rel, key=lambda t: -t[1])[:15]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", default="demo")
    ap.add_argument("--train-seed", type=int, default=0)
    ap.add_argument("--train-steps", default="0",
                    help="comma-separated step counts at which to compare (ascending)")
    ap.add_argument("--n-per-class", type=int, default=60)
    ap.add_argument("--threshold", type=float, default=1e-4)
    ap.add_argument("--work", default=str(ROOT / "build" / "step_compare"))
    ap.add_argument("--device", default="cuda",
                    help="the side held against the CPU (cpu: a rehearsal, both sides equal)")
    args = ap.parse_args(argv)

    make_deterministic()
    import dataclasses

    import torch

    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer

    counts = sorted(int(c) for c in args.train_steps.split(","))
    cfg, raw = floor_config(pathlib.Path(args.work), args.n_per_class, max(counts) + 1,
                            args.width)
    build_floor_corpus(cfg, raw, "cpu")
    trainer = Trainer(cfg.replace(train=dataclasses.replace(cfg.train, seed=args.train_seed)),
                      device=args.device, loader_workers=0)
    trainer.state.generator = torch.Generator().manual_seed(args.train_seed + 1)
    batch = next(trainer.train_ds.batches(group_size=4, seed=args.train_seed + 1))
    card = card_name() if args.device.startswith("cuda") else "cpu"
    for count in counts:
        if count > trainer.state.step:
            trainer.train(max_steps=count)
        result = compare(trainer, batch, trainer.state.generator.get_state(), args.threshold)
        print(json.dumps({"metric": "step_compare", "device": card, "width": args.width,
                          "train_seed": args.train_seed, "at_step": trainer.state.step,
                          **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
