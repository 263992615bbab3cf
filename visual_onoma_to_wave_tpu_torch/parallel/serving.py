"""Batch-sharded synthesis over several devices (port of
visual_onoma_to_wave_tpu/parallel/serving.py).

`make_sharded_synth` keeps one replica of the acoustic model and the
vocoder on each device of a list, splits a padded batch by rows, runs each
replica's share as the fused serving step (`synthesis.make_fused_infer`)
and concatenates the results: requests are independent, so no collective
is needed. With the list of local cards it serves one batch over all of
them; the kernels run on each.
"""
from __future__ import annotations

import copy
from typing import Sequence

import numpy as np
import torch

from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer, resolve_device


def make_sharded_synth(model, gen, devices: Sequence[str | torch.device]):
    """Replicas of (`model`, `gen`) on each of `devices`; returns run(batch,
    e_control=1.0, d_control=1.0) -> (wavs (B, T*hop), mel_lens (B,)) as
    numpy. `batch` is the Synthesizer's dict (audiotypes, texts, src_lens,
    image_cells) of arrays; its batch size must divide by the number of
    devices. Controls are scalars or per-item (B,)."""
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("make_sharded_synth needs at least one device")
    replicas = []
    for d in devices:
        m, g = (copy.deepcopy(x).to(d).eval() for x in (model, gen))
        replicas.append((d, make_fused_infer(m, g)))

    def run(batch: dict, e_control=1.0, d_control=1.0):
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
        for i, (dev, fused) in enumerate(replicas):    # each enqueues on its own device
            sl = slice(i * rows, (i + 1) * rows)
            part = {k: torch.from_numpy(np.ascontiguousarray(np.asarray(v)[sl])).to(dev)
                    for k, v in batch.items() if v is not None}
            out = fused(part, e_control=torch.from_numpy(e[sl]).to(dev),
                        d_control=torch.from_numpy(dc[sl]).to(dev))
            outs.append((out["wav"], out["mel_lens"]))
        wavs = np.concatenate([w.cpu().numpy() for w, _ in outs])
        lens = np.concatenate([m.cpu().numpy() for _, m in outs])
        return wavs, lens

    return run
