"""End-user synthesis API (port of visual_onoma_to_wave_tpu/synthesis.py).

    synth = Synthesizer.from_checkpoint(config, "acoustic.npz", "vocoder.npz", device="cuda")
    result = synth.synthesize("パンパン", "drum", width_rates=[1.0, 0.6, 1.0, 0.6])

`make_fused_infer` is the serving hot path: acoustic forward and vocoder as
one call per padded batch. `Synthesizer` keeps the reference's surface
(`synthesize`, `synthesize_batch`, `vocode`, `batch_signature`, `metadata`,
`symbol_map`, `use_image`, `vocoder_params`, `config`, `mel_bucket`), which
the port's `serve.BatchingServer` serves. The host modules (config,
renderer, symbols) are the port's own, imported where used so that the
compute core here imports with torch and numpy alone. Not ported: the
device mesh and the persistent compile cache.

The compute dtype lives in the modules: `Synthesizer.from_checkpoint` builds
the acoustic model of `train.compute_dtype` (`VTTS.from_config`: bf16 FFT
stacks and PostNet) and `load_vocoder` the vocoder of `model.vocoder_kwargs`,
whose `dtype` ("bfloat16") reaches `get_vocoder` as the JAX Synthesizer's
kwargs reach its `get_vocoder`; the fused call and `vocode` take the mel and
return the waveform in fp32 whatever the dtypes.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from visual_onoma_to_wave_tpu_torch.bridge import load_npz, vocoder_state_dict, vtts_state_dict
from visual_onoma_to_wave_tpu_torch.models.vocoder import generate, get_vocoder, vocoder_infer
from visual_onoma_to_wave_tpu_torch.models.vtts import VTTS
from visual_onoma_to_wave_tpu_torch.precision import pin_fp32


@dataclass
class SynthesisResult:
    wav: Optional[np.ndarray]          # (samples,) or None without a vocoder
    mel: Optional[np.ndarray]          # (T, n_mels) postnet mel, None if not requested
    durations: np.ndarray              # (n_chars,) predicted frame counts
    energy: Optional[np.ndarray]       # (n_chars,) predicted (normalized)
    image: Optional[np.ndarray]        # (H, W) rendered visual onomatopoeia
    mel_len: Optional[int] = None      # predicted mel frames (>= 1 clamped)


def make_fused_infer(model: VTTS, gen):
    """Acoustic forward + vocoder as one call: `fused(batch, e_control,
    d_control) -> outputs of model(...) plus "wav"`. `batch` holds
    audiotypes, texts, src_lens and, on the image path, image_cells, as
    tensors on the models' device; controls are scalars or per-item (B,).
    The vocoder runs through `vocode` (MelGAN is fed mel / ln 10)."""

    @torch.inference_mode()
    def fused(batch: dict, e_control=1.0, d_control=1.0) -> dict:
        out = model(batch["audiotypes"], batch["texts"], batch["src_lens"],
                    image_cells=batch.get("image_cells"),
                    e_control=e_control, d_control=d_control)
        return {**out, "wav": vocode(gen, out["postnet_mel"])}

    return fused


def load_vocoder(config, path: str):
    """The configured vocoder family (`model.vocoder_model`, its
    `vocoder_kwargs`) with the weights of the `.npz` tree at `path`."""
    family = config.model.vocoder_model
    gen = get_vocoder(family, **dict(config.model.vocoder_kwargs))
    gen.load_state_dict(vocoder_state_dict(family, load_npz(path)))
    return gen


def vocode(gen, mel: torch.Tensor) -> torch.Tensor:
    """(B, T, n_mels) natural-log mels -> (B, samples) waveforms through
    `models.vocoder.generate` (which feeds a MelGAN mel / ln 10)."""
    return generate(gen, mel)


def resolve_device(device: str | torch.device) -> torch.device:
    """A torch.device; a CUDA device without CUDA raises (never drops to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        pin_fp32()
    return device


class Synthesizer:
    def __init__(self, config, model: VTTS, metadata, symbol_map: dict[str, int],
                 vocoder=None, device: str | torch.device = "cuda"):
        """config: a `config.Config`; model and vocoder (a generator module,
        or None for mel-only synthesis) hold their weights."""
        from visual_onoma_to_wave_tpu_torch.data.renderer import VisualTextRenderer

        self.device = resolve_device(device)
        self.config = config
        self.model = model.to(self.device).eval()
        self.vocoder = vocoder.to(self.device).eval() if vocoder is not None else None
        self.metadata = metadata
        self.symbol_map = symbol_map
        self.use_image = config.train.use_image
        self.cell_width = metadata.max_pixelsize
        self.renderer = VisualTextRenderer.from_config(config)
        self._fused = make_fused_infer(self.model, self.vocoder) if vocoder is not None else None
        # serializes calls: the server can have two in-flight device calls,
        # and module forwards are not re-entrant on one stream
        self._lock = threading.Lock()
        self.text_bucket = 4
        self.mel_bucket = 64

    @property
    def vocoder_params(self):
        """The generator's parameters (None without a vocoder); the reference
        server reads this to report whether audio is produced."""
        return None if self.vocoder is None else self.vocoder.state_dict()

    @classmethod
    def from_checkpoint(cls, config, acoustic: str, vocoder: Optional[str] = None,
                        device: str | torch.device = "cuda") -> "Synthesizer":
        """Load the acoustic (and vocoder) `.npz` trees written by
        `examples/export_demo_for_torch.py`, with metadata and vocabulary from
        `config.path.preprocessed`."""
        from visual_onoma_to_wave_tpu_torch.config import DatasetMetadata
        from visual_onoma_to_wave_tpu_torch.data.symbols import build_symbol_map, load_symbol_map

        metadata = DatasetMetadata.load(config.path.preprocessed)
        symbol_map = (load_symbol_map(config.path.preprocessed)
                      or build_symbol_map(config.path.preprocessed))
        model = VTTS.from_config(config, metadata, n_vocab=len(symbol_map))
        model.load_state_dict(vtts_state_dict(load_npz(acoustic)))
        gen = load_vocoder(config, vocoder) if vocoder is not None else None
        return cls(config, model, metadata, symbol_map, gen, device=device)

    # ------------------------------------------------------------ inputs
    _TEXT_STRIP = str.maketrans("", "", "{}\n")

    def _clean_text(self, text: str) -> str:
        clean = text.translate(self._TEXT_STRIP)
        if not clean:
            raise ValueError("text is empty (after removing '{', '}' and newlines)")
        return clean

    def _encode(self, text: str) -> np.ndarray:
        """Ids; on the image path unknown characters map to PAD (ids are unused)."""
        if self.use_image:
            return np.asarray([self.symbol_map.get(c, 0) for c in text], np.int32)
        from visual_onoma_to_wave_tpu_torch.data.symbols import encode_text
        try:
            return np.asarray(encode_text(text, self.symbol_map), np.int32)
        except KeyError as e:
            raise KeyError(f"character {e.args[0]!r} not in the training vocabulary "
                           f"(use_image=False synthesizes from token ids)") from e

    def _render_cells(self, text: str, width_rates: Sequence[float]) -> np.ndarray:
        """(n_chars, H, cell_width) float32 cells in [0, 1]."""
        strip = self.renderer.draw_with_width_rates(
            text, list(width_rates), cell_width=self.cell_width, grayscale=True)
        H = strip.shape[0]
        return (strip.reshape(H, len(text), self.cell_width).transpose(1, 0, 2)
                .astype(np.float32) / 255.0)

    def _audiotype_id(self, audiotype: str | int) -> int:
        if isinstance(audiotype, str):
            try:
                return self.metadata.audiotype_map[audiotype]
            except KeyError:
                raise ValueError(f"unknown audiotype {audiotype!r}; valid classes: "
                                 f"{sorted(self.metadata.audiotype_map)}") from None
        return int(audiotype)

    @staticmethod
    def _check_controls(e_control, d_control, width_rates=None) -> None:
        for name, v in (("e_control", e_control), ("d_control", d_control)):
            arr = np.asarray(v, np.float64)
            if not np.all(np.isfinite(arr)) or np.any(arr < 0):
                raise ValueError(f"{name} must be finite and >= 0, got {v!r}")
        if width_rates is not None:
            arr = np.asarray(list(width_rates), np.float64)
            if not np.all(np.isfinite(arr)) or np.any(arr <= 0):
                raise ValueError(f"width_rates must be finite and > 0, got {width_rates!r}")

    def batch_signature(self, texts: Sequence[str]) -> tuple[int, int]:
        """(padded_batch, padded_text_len): batch to a power of two, text
        length to a multiple of `text_bucket`."""
        b_pad = max(1, 1 << (len(texts) - 1).bit_length())
        n_max = max(len(t) for t in texts)
        return b_pad, -(-n_max // self.text_bucket) * self.text_bucket

    def _run(self, batch: dict, e_ctl: np.ndarray, d_ctl: np.ndarray) -> dict:
        dev = self.device
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        e_ctl, d_ctl = torch.from_numpy(e_ctl).to(dev), torch.from_numpy(d_ctl).to(dev)
        with self._lock:
            if self._fused is not None:
                out = self._fused(batch, e_control=e_ctl, d_control=d_ctl)
            else:
                with torch.inference_mode():
                    out = self.model(batch["audiotypes"], batch["texts"], batch["src_lens"],
                                     image_cells=batch.get("image_cells"),
                                     e_control=e_ctl, d_control=d_ctl)
            return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                    for k, v in out.items()}

    # ------------------------------------------------------------ synthesis
    def vocode(self, mels: np.ndarray, mel_lens: Sequence[int]) -> list[np.ndarray]:
        """Externally produced (B, T, n_mels) natural-log mels -> one waveform
        of mel_len x hop samples per item. The batch is zero-padded to a
        multiple of `mel_bucket` frames (the reference's bucketing, so the
        samples equal its) and vocoded in one call; the text -> wav paths use
        the fused call instead."""
        if self.vocoder is None:
            raise ValueError("vocode needs a vocoder: load one with the Synthesizer")
        hop = self.config.audio.stft.hop_length
        t = mels.shape[1]
        t_pad = -(-t // self.mel_bucket) * self.mel_bucket
        mels = np.pad(np.asarray(mels, np.float32), ((0, 0), (0, t_pad - t), (0, 0)))
        with self._lock, torch.inference_mode():
            wavs, lens = vocoder_infer(self.vocoder, torch.from_numpy(mels).to(self.device),
                                       np.asarray(mel_lens, int), hop)
        wavs = wavs.cpu().numpy()
        return [wavs[i, :n] for i, n in enumerate(lens)]

    def synthesize(self, text: str, audiotype: str | int,
                   width_rates: Optional[Sequence[float]] = None,
                   e_control: float = 1.0, d_control: float = 1.0) -> SynthesisResult:
        """One request: a batch of one through the same fused call. `wav` is
        None when every duration rounds to 0 (mel_len is then clamped to 1)."""
        text = self._clean_text(text)
        if width_rates is not None and len(width_rates) != len(text):
            raise ValueError(f"width_rates has {len(width_rates)} entries for "
                             f"{len(text)} characters")
        result = self.synthesize_batch([text], [audiotype], width_rates=[width_rates],
                                       e_control=e_control, d_control=d_control)[0]
        if result.durations.sum() == 0:
            result.wav = None    # no predicted frame: no audio, as the reference
        return result

    def synthesize_batch(self, texts: Sequence[str], audiotypes: Sequence[str | int],
                         width_rates: Optional[Sequence[Optional[Sequence[float]]]] = None,
                         e_control: float | Sequence[float] = 1.0,
                         d_control: float | Sequence[float] = 1.0,
                         return_mel: bool = True) -> list[SynthesisResult]:
        """Batched text -> waveform in one fused call; batch size and text
        length are bucketed as in the reference. Controls are scalars or
        per-item sequences. return_mel=False leaves `mel` None."""
        if len(texts) != len(audiotypes):
            raise ValueError(f"{len(texts)} texts but {len(audiotypes)} audiotypes")
        texts = [self._clean_text(t) for t in texts]
        bsz = len(texts)
        width_rates = [None] * bsz if width_rates is None else width_rates
        self._check_controls(e_control, d_control)
        for wr in width_rates:
            if wr is not None:
                self._check_controls(1.0, 1.0, wr)
        b_pad, C = self.batch_signature(texts)

        ids = np.zeros((b_pad,), np.int32)
        text_ids = np.zeros((b_pad, C), np.int32)
        src_lens = np.ones((b_pad,), np.int32)
        cells = np.ones((b_pad, C, self.metadata.image_height, self.cell_width), np.float32)
        images = []
        for i, (text, at) in enumerate(zip(texts, audiotypes)):
            ids[i] = self._audiotype_id(at)
            n = len(text)
            src_lens[i] = n
            text_ids[i, :n] = self._encode(text)
            if self.use_image:
                c = self._render_cells(text, width_rates[i] or [1.0] * n)
                cells[i, :n] = c
                images.append((c.transpose(1, 0, 2).reshape(c.shape[1], -1) * 255
                               ).astype(np.uint8))
            else:
                images.append(None)
        batch = {"audiotypes": ids, "texts": text_ids, "src_lens": src_lens}
        if self.use_image:
            batch["image_cells"] = cells

        def column(c) -> np.ndarray:
            col = np.ones((b_pad,), np.float32)
            col[:bsz] = np.asarray(c, np.float32)
            return col

        out = self._run(batch, column(e_control), column(d_control))
        mel_lens = out["mel_lens"][:bsz].astype(int)
        durs = out["duration_rounded"][:bsz].astype(np.int32)
        energies = out["energy_pred"][:bsz] if out["energy_pred"] is not None else None
        hop = self.config.audio.stft.hop_length
        results = []
        for i, text in enumerate(texts):
            n, ml = len(text), max(int(mel_lens[i]), 1)
            results.append(SynthesisResult(
                wav=out["wav"][i, :ml * hop] if "wav" in out else None,
                mel=out["postnet_mel"][i, :ml] if return_mel else None,
                durations=durs[i, :n],
                energy=energies[i, :n] if energies is not None else None,
                image=images[i], mel_len=ml))
        return results
