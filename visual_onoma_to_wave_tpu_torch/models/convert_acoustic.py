"""The reference vTTS acoustic checkpoint -> the port's acoustic `.npz` tree
(port of visual_onoma_to_wave_tpu/models/convert_acoustic.py).

The reference's state_dict layout (its scripts/model/vtts.py module tree:
encoder / variance_adaptor / decoder / mel_linear / postnet /
audiotype_emb) is the port's own parameter naming, so a checkpoint such as
the published `200000.pth.tar` converts by dropping what the model
re-derives and writing the flax-layout tree through `bridge.vtts_tree`:
the `<ckpt>/<step>/acoustic.npz` layout that `Synthesizer.from_checkpoint`
reads. The tree equals the JAX `load_torch_acoustic`'s leaf for leaf, bit
for bit (`tests/test_torch_convert.py`).

    python -m visual_onoma_to_wave_tpu_torch.cli convert-acoustic 200000.pth.tar acoustic.npz

Skipped, as by the JAX converter: the sinusoid tables (`position_enc`), the
variance bins (rebuilt from stats.json) and BatchNorm's batch counters.
"""
from __future__ import annotations

import pathlib

import numpy as np
import torch

from visual_onoma_to_wave_tpu_torch.bridge import save_npz, torch_checkpoint_state, vtts_tree

# buffers the model re-derives: never converted
REDERIVED = ("position_enc", "energy_bins", "kurtosis_bins", "pitch_bins",
             "num_batches_tracked")
_BRIDGE = "encoder.VisualFeatureExtractor.bridge"


def convert_vtts_state_dict(state: dict[str, np.ndarray]) -> dict:
    """A reference-layout vTTS state_dict (numpy) -> {"params",
    "batch_stats"} as numpy arrays in the flax layout. The VP kernel size is
    the reference's 3 (its second conv hard-codes padding 1)."""
    sd = {}
    for k, v in state.items():
        if k.rsplit(".", 1)[-1] in REDERIVED:
            continue
        if k.startswith(f"{_BRIDGE}.") and not k.startswith(f"{_BRIDGE}.0."):
            k = f"{_BRIDGE}.0.{k[len(_BRIDGE) + 1:]}"     # a bare Linear bridge
        sd[k] = torch.from_numpy(np.asarray(v, np.float32))
    for p in ("duration", "energy", "kurtosis"):
        w = sd.get(f"variance_adaptor.{p}_predictor.conv_layer.conv1d_2.conv.weight")
        if w is not None and w.shape[-1] != 3:
            raise ValueError(f"{p} predictor kernel {w.shape[-1]}: the reference's second VP "
                             "conv hard-codes padding 1, SAME only for kernel 3")
    return vtts_tree(sd)


def load_torch_acoustic(ckpt_path: str | pathlib.Path) -> dict:
    """The acoustic checkpoint's `ckpt['model']` (DataParallel prefix
    stripped) as the port's {"params", "batch_stats"} tree."""
    return convert_vtts_state_dict(torch_checkpoint_state(ckpt_path, "model"))


def convert_acoustic(ckpt_path: str | pathlib.Path, out: str | pathlib.Path) -> dict:
    """Convert `ckpt_path` and write the `.npz` tree to `out`; returns the tree."""
    tree = load_torch_acoustic(ckpt_path)
    save_npz(out, tree)
    return tree
