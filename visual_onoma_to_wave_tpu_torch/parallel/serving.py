"""Batch-sharded synthesis over several devices (port of
visual_onoma_to_wave_tpu/parallel/serving.py).

`make_sharded_fused` keeps one replica of the acoustic model (and the
vocoder) on each device of a list, splits a padded batch by rows, runs each
replica's share as the fused serving step (`synthesis.make_fused_infer`)
and concatenates the results in row order: requests are independent, so no
collective is needed. With the list of local cards it serves one batch over
all of them; the kernels run on each. `Synthesizer(devices=[...])` serves
through it; `make_sharded_synth` is its (waveforms, mel lengths) view.
"""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from visual_onoma_to_wave_tpu_torch.synthesis import (make_fused_infer, resolve_device, to_device,
                                                      to_host)

# the outputs a served batch reads (`Synthesizer.synthesize_batch`)
SERVED_OUTPUTS = ("postnet_mel", "mel_lens", "duration_rounded", "energy_pred", "wav")


def _mel_only(model):
    @torch.inference_mode()
    def fused(batch: dict, e_control=1.0, d_control=1.0) -> dict:
        return model(batch["audiotypes"], batch["texts"], batch["src_lens"],
                     image_cells=batch.get("image_cells"),
                     e_control=e_control, d_control=d_control)

    return fused


def _indexed(device: torch.device) -> torch.device:
    """'cuda' as the card it means ('cuda:<current>'), so that devices compare."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def make_sharded_fused(model, gen, devices: Sequence[str | torch.device]):
    """Replicas of (`model`, `gen`; `gen` None for mel-only synthesis) on each
    of `devices`; returns run(batch, e_control=1.0, d_control=1.0) -> dict of
    numpy arrays (`SERVED_OUTPUTS`, None where the model gives None), rows in
    the batch's order. `batch` is the Synthesizer's dict (audiotypes, texts,
    src_lens, image_cells) of arrays; its batch size must divide by the number
    of devices. Controls are scalars or per-item (B,). The first replica on
    the device that `model` already lives on is `model` itself."""
    devices = [_indexed(resolve_device(d)) for d in devices]
    if not devices:
        raise ValueError("make_sharded_fused needs at least one device")
    home = next(model.parameters()).device
    replicas = []
    for d in devices:
        if d == _indexed(home) and not any(r[1] is model for r in replicas):
            m, g = model.eval(), gen.eval() if gen is not None else None
        else:
            m = copy.deepcopy(model).to(d).eval()
            g = copy.deepcopy(gen).to(d).eval() if gen is not None else None
        replicas.append((d, m, make_fused_infer(m, g) if g is not None else _mel_only(m)))

    def run(batch: dict, e_control=1.0, d_control=1.0) -> dict:
        B = batch["texts"].shape[0]
        n = len(replicas)
        if B % n:
            raise ValueError(f"batch size {B} is not divisible by the {n} devices; pad the "
                             "batch to a multiple (Synthesizer.batch_signature does this)")
        rows = B // n

        def ctl(c) -> np.ndarray:
            col = np.ones((B,), np.float32)
            col[:] = np.asarray(c, np.float32)     # a scalar broadcasts
            return col

        e, dc = ctl(e_control), ctl(d_control)
        outs = []
        for i, (dev, _, fused) in enumerate(replicas):    # each enqueues on its own device
            sl = slice(i * rows, (i + 1) * rows)
            part = to_device({**{k: np.asarray(v)[sl] for k, v in batch.items() if v is not None},
                              "e_control": e[sl], "d_control": dc[sl]}, dev)
            e_part, d_part = part.pop("e_control"), part.pop("d_control")
            outs.append(fused(part, e_control=e_part, d_control=d_part))
        hosts = [to_host({k: o[k] for k in SERVED_OUTPUTS if k in o}) for o in outs]
        return {k: None if hosts[0][k] is None else np.concatenate([h[k] for h in hosts])
                for k in hosts[0]}

    return run


def make_sharded_synth(model, gen, devices: Sequence[str | torch.device]):
    """`make_sharded_fused` returning (wavs (B, T*hop), mel_lens (B,)) as numpy."""
    fused = make_sharded_fused(model, gen, devices)

    def run(batch: dict, e_control=1.0, d_control=1.0):
        out = fused(batch, e_control=e_control, d_control=d_control)
        return out["wav"], out["mel_lens"]

    return run
