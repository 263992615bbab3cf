"""Training checkpoints as `.npz` files (the port's counterpart of
visual_onoma_to_wave_tpu/utils/checkpoint.py, which uses orbax).

    <ckpt>/<step>/acoustic.npz     the model in the flax-tree layout, with
                                   batch_stats (`bridge.vtts_tree`): what
                                   `Synthesizer.from_checkpoint` reads as it is
    <ckpt>/<step>/train_state.npz  the mini-step count, the optimizer's counts,
                                   Adam's moments and steps, the accumulation
                                   buffers and the dropout generator's state

A step directory is written under a temporary name and renamed when both
files are complete. The newest `max_to_keep` steps are kept (20, as in the
reference); `restore(step=None)` or `step=-1` takes the latest.
"""
from __future__ import annotations

import pathlib
import shutil

import numpy as np
import torch

from visual_onoma_to_wave_tpu_torch.bridge import load_npz, save_npz, vtts_state_dict, vtts_tree

ACOUSTIC = "acoustic.npz"
TRAIN_STATE = "train_state.npz"


def _param_names(model: torch.nn.Module) -> list[str]:
    return [n for n, p in model.named_parameters() if p.requires_grad]


def acoustic_path(ckpt_dir: str | pathlib.Path, step: int | None = None) -> pathlib.Path:
    """`<ckpt_dir>/<step>/acoustic.npz` of a complete checkpoint, at `step`
    (None or -1: the latest). Raises FileNotFoundError naming the directory
    when there is no such step; creates nothing."""
    d = pathlib.Path(ckpt_dir).absolute()
    steps = (sorted(int(p.name) for p in d.iterdir()
                    if p.name.isdigit() and (p / TRAIN_STATE).exists())
             if d.is_dir() else [])
    if step in (None, -1):
        step = steps[-1] if steps else None
    if step is None or step not in steps:
        have = f"steps {steps}" if steps else "no checkpoint"
        raise FileNotFoundError(f"no checkpoint at step {step} under {d} ({have})")
    return d / str(step) / ACOUSTIC


class CheckpointManager:
    def __init__(self, ckpt_dir: str | pathlib.Path, max_to_keep: int = 20):
        self.dir = pathlib.Path(ckpt_dir).absolute()
        self.dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def all_steps(self) -> list[int]:
        return sorted(int(p.name) for p in self.dir.iterdir()
                      if p.name.isdigit() and (p / TRAIN_STATE).exists())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state, step: int | None = None) -> pathlib.Path:
        """Write `state` (a `training.train_state.TrainState`) at `step`
        (default: its own) and drop all but the newest `max_to_keep` steps."""
        step = state.step if step is None else step
        final = self.dir / str(step)
        tmp = self.dir / f".{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        save_npz(tmp / ACOUSTIC, vtts_tree(state.model.state_dict()))
        arrays = state.optimizer.state_arrays(_param_names(state.model))
        arrays["step"] = torch.tensor(state.step)
        arrays["generator_state"] = state.generator.get_state()
        np.savez(tmp / TRAIN_STATE, **{k: v.numpy() for k, v in arrays.items()})
        shutil.rmtree(final, ignore_errors=True)
        tmp.rename(final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(self.dir / str(old))
        return final

    def restore(self, state, step: int | None = None):
        """Load the checkpoint at `step` (None or -1: the latest) into
        `state` in place and return it."""
        if step is None or step == -1:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / str(step)
        state.model.load_state_dict(vtts_state_dict(load_npz(d / ACOUSTIC)))
        with np.load(d / TRAIN_STATE) as f:
            arrays = {k: torch.from_numpy(f[k]) for k in f.files}
        state.optimizer.load_state_arrays(_param_names(state.model), arrays)
        state.generator.set_state(arrays["generator_state"])
        state.step = int(arrays["step"])
        return state
