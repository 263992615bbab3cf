"""The exported serving artifact (port of visual_onoma_to_wave_tpu/export.py).

`export_synthesizer` traces the fused serving step (`synthesis.
make_fused_infer`: acoustic forward and vocoder in one call, the hot path
behind `Synthesizer.synthesize_batch` and the HTTP server) with
`torch.export` and saves it as a self-contained artifact:

  out_dir/
    manifest.json           # buckets, devices, versions
    config.json             # the full Config (renderer, audio, model)
    symbols.json            # the training vocabulary
    metadata/               # DatasetMetadata files (audiotype, stats, ...)
    fused_{device}.pt2      # one program per device (`torch.export.save`)

Each program holds the acoustic and vocoder weights once: its batch and text
dimensions are dynamic (`torch.export.Dim`; the text length a multiple of
`text_bucket`), so every (batch, text) bucket of the manifest runs the one
program. The kernels are custom ops (`votw::attention_core`,
`votw::mrf_stage_fused`, `votw::convnext_block`, `votw::conv1d_tc`) that the
graph calls by name: a `cuda` program launches them on the card, a `cpu`
program runs their plain versions. The packing of the MRF and ConvNeXt
weights for the kernels is traced into the graph; the acoustic convs'
weights for `votw::conv1d_tc` are packed before the trace and held as
buffers. `ExportedSynthesizer.load(dir)` is a drop-in
`Synthesizer` (`synthesize`, `synthesize_batch`, `batch_signature`, so
`serve.BatchingServer` and `cli serve --exported` take it unchanged) that
needs no checkpoint and no model code: only the package's custom ops, which
importing this module registers.

A `cuda` program is traced on the card and loading it without a card
raises: no artifact falls back to the CPU. The e/d controls are (B,) inputs,
so any mix of per-item controls shares the program. A synthesizer of bf16
compute (`train.compute_dtype`, a vocoder's `dtype`) exports as it runs: the
casts are traced, the custom ops' fake implementations return the dtype of
their inputs, the programs launch the kernels' bf16 instantiations, and the
manifest records both compute dtypes.
"""
from __future__ import annotations

import json
import pathlib
import threading
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

# registers the custom ops the programs call
import visual_onoma_to_wave_tpu_torch.ops  # noqa: F401
from visual_onoma_to_wave_tpu_torch import tracing
from visual_onoma_to_wave_tpu_torch.synthesis import (Synthesizer, resolve_device, to_device,
                                                      to_host, vocode)

MANIFEST = "manifest.json"
FORMAT_VERSION = 1
DEVICES = ("cpu", "cuda")
# what every program returns, in this order (the part of the fused step's
# dict that synthesize_batch reads)
_OUT_KEYS = ("postnet_mel", "mel_lens", "duration_rounded", "energy_pred", "wav")


def _program_name(device: str) -> str:
    return f"fused_{device}.pt2"


class _FusedStep(nn.Module):
    """The fused serving step as one module: what `torch.export` traces."""

    def __init__(self, model: nn.Module, gen: nn.Module):
        super().__init__()
        self.model, self.gen = model, gen

    def forward(self, audiotypes, texts, src_lens, e_control, d_control, image_cells=None):
        out = self.model(audiotypes, texts, src_lens, image_cells=image_cells,
                         e_control=e_control, d_control=d_control)
        out["wav"] = vocode(self.gen, out["postnet_mel"])
        return tuple(out[k] for k in _OUT_KEYS)


def validate_devices(devices: Sequence[str]) -> list[str]:
    """The artifact's devices, each "cpu" or "cuda", at least one."""
    devices = [d.strip() for d in devices if d.strip()]
    bad = [d for d in devices if d not in DEVICES]
    if bad or not devices:
        raise ValueError(f"devices must be among {DEVICES}, got {devices!r}")
    return list(dict.fromkeys(devices))


def export_synthesizer(synth: Synthesizer, out_dir: str | pathlib.Path, *, max_batch: int = 8,
                       text_lens: Optional[Sequence[int]] = None,
                       devices: Sequence[str] = ("cuda",)) -> dict:
    """Trace `synth`'s fused serving step for every (batch, text-len) bucket
    up to `max_batch` x max(text_lens) and save the artifact; returns the
    manifest dict. Buckets mirror `Synthesizer.batch_signature`:
    power-of-two batch sizes and `text_bucket`-multiple text lengths, so a
    served request runs at the live path's shapes. `text_lens` defaults to
    one and two text buckets. Each device's program is traced from a copy
    of the models on that device ("cuda" needs a card)."""
    if synth.vocoder is None:
        raise ValueError("export requires a vocoder (the artifact ships the fused "
                         "text->waveform path); load the Synthesizer with one")
    devices = validate_devices(devices)
    tb = synth.text_bucket
    if text_lens is None:
        text_lens = (tb, 2 * tb)
    text_lens = sorted({((int(c) + tb - 1) // tb) * tb for c in text_lens})
    if any(c <= 0 for c in text_lens):
        raise ValueError(f"text_lens must be positive, got {text_lens!r}")
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch!r}")
    batches = [1 << i for i in range(int(max_batch).bit_length()) if 1 << i <= max_batch]
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    for device in devices:
        dev = resolve_device(device)
        same = dev == synth.device
        step = _FusedStep(synth.model if same else _copy_to(synth.model, dev),
                          synth.vocoder if same else _copy_to(synth.vocoder, dev)).eval()
        # trace at a bucket whose dimensions are not 0/1 (torch.export
        # specialises those), then let batch and text buckets vary
        b0, c0 = max(batches[-1], 2), text_lens[-1]
        args, kwargs = _example_inputs(synth, b0, c0, dev)
        batch = torch.export.Dim("batch", min=1, max=max(batches[-1], 2))
        n_text = text_lens[-1] // tb    # one text bucket: a static text length
        text = tb * torch.export.Dim("text_buckets", min=1, max=n_text) if n_text > 1 else None
        shapes = {"audiotypes": {0: batch}, "texts": {0: batch, 1: text},
                  "src_lens": {0: batch}, "e_control": {0: batch}, "d_control": {0: batch},
                  "image_cells": {0: batch, 1: text} if synth.use_image else None}
        if text is None:
            shapes["texts"] = {0: batch}
            if synth.use_image:
                shapes["image_cells"] = {0: batch}
        step.model.pack_kernel_weights(dev)    # B7's weights go in as buffers
        with torch.no_grad():
            program = torch.export.export(step, args, kwargs, dynamic_shapes=shapes)
        torch.export.save(program, out / _program_name(device))

    synth.config.save(out / "config.json")
    from visual_onoma_to_wave_tpu_torch.data.symbols import save_symbol_map

    save_symbol_map(out, synth.symbol_map)
    synth.metadata.save(out / "metadata")
    manifest = {
        "format_version": FORMAT_VERSION,
        "buckets": [[b, c] for b in batches for c in text_lens],
        "text_bucket": tb,
        "use_image": synth.use_image,
        "devices": devices,
        "torch_version": torch.__version__,
        "sampling_rate": synth.config.audio.sampling_rate,
        "hop_length": synth.config.audio.stft.hop_length,
        "vocoder_model": synth.config.model.vocoder_model,
        "acoustic_dtype": str(synth.model.dtype).removeprefix("torch."),
        "vocoder_dtype": str(getattr(synth.vocoder, "dtype", torch.float32)).removeprefix("torch."),
    }
    with open(out / MANIFEST, "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def _copy_to(module: nn.Module, device: torch.device) -> nn.Module:
    import copy

    return copy.deepcopy(module).to(device).eval()


def _example_inputs(synth: Synthesizer, b: int, c: int, device: torch.device):
    """(args, kwargs) of `_FusedStep.forward` at batch b and text length c,
    with the live path's pad values."""
    args = (torch.zeros(b, dtype=torch.int32, device=device),
            torch.zeros(b, c, dtype=torch.int32, device=device),
            torch.full((b,), c, dtype=torch.int32, device=device),
            torch.ones(b, device=device), torch.ones(b, device=device))
    kwargs = {}
    if synth.use_image:
        kwargs["image_cells"] = torch.ones(b, c, synth.metadata.image_height, synth.cell_width,
                                           device=device)
    return args, kwargs


class ExportedSynthesizer(Synthesizer):
    """The `Synthesizer` surface served from an exported artifact: text
    encoding, rendering, bucketing, control checks and result trimming are
    the inherited ones; the device call runs the artifact's program for
    `device` after padding the batch up to the smallest shipped bucket.

    Construct with `ExportedSynthesizer.load(dir, device="cuda")`. Unlike the
    live class it needs no checkpoint and no preprocessed directory, and
    `vocode()` (the external-mel path) is not shipped: the artifact is the
    fused text->waveform program only."""

    def __init__(self, export_dir: str | pathlib.Path, device: str | torch.device = "cuda"):
        from visual_onoma_to_wave_tpu_torch.config import DatasetMetadata, config_from_dict
        from visual_onoma_to_wave_tpu_torch.data.renderer import VisualTextRenderer
        from visual_onoma_to_wave_tpu_torch.data.symbols import load_symbol_map

        d = pathlib.Path(export_dir)
        with open(d / MANIFEST) as f:
            manifest = json.load(f)
        if manifest.get("format_version") != FORMAT_VERSION:
            raise ValueError(f"unsupported export format_version "
                             f"{manifest.get('format_version')!r} (expected {FORMAT_VERSION}; "
                             "re-export with this library version)")
        device = torch.device(device)
        if device.type not in manifest["devices"]:
            raise ValueError(f"the artifact holds programs for {manifest['devices']}, not "
                             f"{device.type!r}; re-export with devices=(..., {device.type!r})")
        self.device = resolve_device(device)    # a cuda artifact without a card raises
        with open(d / "config.json") as f:
            self.config = config_from_dict(json.load(f))
        self.manifest = manifest
        self.metadata = DatasetMetadata.load(d / "metadata")
        symbol_map = load_symbol_map(d)
        if symbol_map is None:
            raise FileNotFoundError(f"no symbols.json in {d}")
        self.symbol_map = symbol_map
        self.model = None
        self.vocoder = None
        self.use_image = bool(manifest["use_image"])
        self.cell_width = self.metadata.max_pixelsize
        self.renderer = VisualTextRenderer.from_config(self.config)
        self.text_bucket = int(manifest["text_bucket"])
        self.mel_bucket = 64
        self._buckets = [(int(b), int(c)) for b, c in manifest["buckets"]]
        path = d / _program_name(self.device.type)
        if not path.exists():
            raise FileNotFoundError(f"manifest lists device {self.device.type!r} but "
                                    f"{path.name} is missing from {d}")
        self._program = torch.export.load(path).module()
        self._lock = threading.Lock()

    @classmethod
    def load(cls, export_dir: str | pathlib.Path,
             device: str | torch.device = "cuda") -> "ExportedSynthesizer":
        return cls(export_dir, device)

    @property
    def vocoder_params(self):
        """Truthy: the vocoder's weights live in the artifact (the server
        reads this to report that audio is produced)."""
        return True

    @property
    def max_batch(self) -> int:
        return max(b for b, _ in self._buckets)

    @property
    def max_text_len(self) -> int:
        """The largest text length a shipped bucket covers. The HTTP edge
        (`serve.BatchingServer`) enforces it, so an over-limit text gets a
        clean 400 instead of failing its whole micro-batch group here."""
        return max(c for _, c in self._buckets)

    def _pick_bucket(self, b: int, c: int) -> tuple[int, int]:
        """The smallest shipped bucket covering (b, c), or an error naming
        the artifact's limits."""
        fits = [(bb, cc) for bb, cc in self._buckets if bb >= b and cc >= c]
        if not fits:
            raise ValueError(f"request needs bucket ({b}, {c}) but the artifact ships max "
                             f"batch {self.max_batch} x max text len {self.max_text_len} — "
                             "re-export with larger max_batch/text_lens")
        return min(fits, key=lambda t: (t[0] * t[1], t))

    def _run(self, batch: dict, e_ctl: np.ndarray, d_ctl: np.ndarray) -> dict:
        b, c = batch["texts"].shape
        bb, cc = self._pick_bucket(int(b), int(c))
        if (bb, cc) != (b, c):
            # pad up to the shipped bucket with the live bucketing's pad
            # values: zero ids, src_len 1, all-ones cells, unit controls; the
            # extra rows and columns are cut by synthesize_batch
            def pad(x, rows, cols=None, value=0):
                widths = [(0, rows - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
                if cols is not None:
                    widths[1] = (0, cols - x.shape[1])
                return np.pad(x, widths, constant_values=value)

            batch = {"audiotypes": pad(batch["audiotypes"], bb),
                     "texts": pad(batch["texts"], bb, cc),
                     "src_lens": pad(batch["src_lens"], bb, value=1),
                     **({"image_cells": pad(batch["image_cells"], bb, cc, value=1.0)}
                        if "image_cells" in batch else {})}
            e_ctl, d_ctl = pad(e_ctl, bb, value=1.0), pad(d_ctl, bb, value=1.0)
        t = to_device({**batch, "e_control": e_ctl, "d_control": d_ctl}, self.device)
        kwargs = {"image_cells": t["image_cells"]} if "image_cells" in t else {}
        with self._locked(), torch.inference_mode():
            with tracing.span("synth.fused"):
                outs = self._program(t["audiotypes"], t["texts"], t["src_lens"],
                                     t["e_control"], t["d_control"], **kwargs)
            return to_host(dict(zip(_OUT_KEYS, outs)))

    def vocode(self, mels, mel_lens):
        raise RuntimeError("ExportedSynthesizer serves the fused text->waveform program only; "
                           "the external-mel vocode() path needs the live Synthesizer (load "
                           "the checkpoint instead)")
