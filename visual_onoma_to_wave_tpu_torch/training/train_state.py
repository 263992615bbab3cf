"""Train, eval and synth steps of the acoustic model (port of
visual_onoma_to_wave_tpu/training/train_state.py).

Plain functions over a `TrainState`: the model, its `NoamAdam`, the
`torch.Generator` every dropout mask is drawn from (on the model's device),
and the count of mini-steps taken. The train step runs the model in
`.train()` (dropout, BatchNorm on batch statistics, attention through its
plain version with autograd: no hand-written kernel runs under autograd);
the eval and synth steps run it in `.eval()` under `torch.no_grad()`, where
the attention kernel runs on the card.

Batches are dicts of tensors on the model's device: audiotypes, texts,
src_lens, image_cells (image path), mels, durations, energies and kurtoses
(when the model conditions on them).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from visual_onoma_to_wave_tpu_torch.models.layers import set_dropout_generator
from visual_onoma_to_wave_tpu_torch.training.loss import fastspeech2_loss
from visual_onoma_to_wave_tpu_torch.training.schedule import NoamAdam, global_norm

MODEL_INPUTS = ("audiotypes", "texts", "src_lens", "image_cells")


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: NoamAdam
    generator: torch.Generator
    step: int = 0          # mini-steps taken (the reference's TrainState.step)


def _teacher_forced(model, batch: dict) -> dict:
    return model(batch["audiotypes"], batch["texts"], batch["src_lens"],
                 image_cells=batch.get("image_cells"),
                 energy_targets=batch.get("energies"),
                 kurtosis_targets=batch.get("kurtoses"),
                 duration_targets=batch["durations"],
                 max_mel_len=batch["mels"].shape[1])


def train_step(state: TrainState, batch: dict) -> dict:
    """Forward with dropout from `state.generator`, the loss, backward, then
    one `NoamAdam.step` (which applies an update every `grad_acc_step`
    mini-steps). Returns the losses and `grad_norm`, the global norm of this
    mini-batch's gradient before clipping, as 0-d tensors on the device."""
    model = state.model
    model.train()
    set_dropout_generator(model, state.generator)
    losses = fastspeech2_loss(_teacher_forced(model, batch), batch)
    state.optimizer.zero_grad()
    losses["total_loss"].backward()
    with torch.no_grad():
        grad_norm = global_norm([p.grad for p in state.optimizer.params if p.grad is not None])
    state.optimizer.step()
    state.step += 1
    return {**{k: v.detach() for k, v in losses.items()}, "grad_norm": grad_norm}


@torch.no_grad()
def eval_step(model, batch: dict) -> tuple[dict, dict]:
    """Teacher-forced deterministic forward: (losses, outputs)."""
    model.eval()
    outputs = _teacher_forced(model, batch)
    return fastspeech2_loss(outputs, batch), outputs


@torch.no_grad()
def synth_step(model, batch: dict, e_control=1.0, d_control=1.0) -> dict:
    """Free-running deterministic forward: predicted durations drive the
    length regulator."""
    model.eval()
    return model(batch["audiotypes"], batch["texts"], batch["src_lens"],
                 image_cells=batch.get("image_cells"), e_control=e_control,
                 d_control=d_control)
