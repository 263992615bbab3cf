"""End-user synthesis API (port of visual_onoma_to_wave_tpu/synthesis.py).

    synth = Synthesizer.from_checkpoint(config, "acoustic.npz", "vocoder.npz", device="cuda")
    synth = Synthesizer.from_checkpoint(config, vocoder="vocoder.npz", restore_step=-1)
    result = synth.synthesize("パンパン", "drum", width_rates=[1.0, 0.6, 1.0, 0.6])

`make_fused_infer` is the serving hot path: acoustic forward and vocoder as
one call per padded batch. `Synthesizer` keeps the reference's surface
(`synthesize`, `synthesize_batch`, `vocode`, `batch_signature`, `metadata`,
`symbol_map`, `use_image`, `vocoder_params`, `config`, `mel_bucket`), which
the port's `serve.BatchingServer` serves. The host modules (config,
renderer, symbols) are the port's own, imported where used so that the
compute core here imports with torch and numpy alone. Not ported: the
persistent compile cache.

Several devices: `devices="auto"` (the default of `from_checkpoint`) takes
every visible card when `device` is a CUDA device and more than one is
visible, as the JAX `mesh="auto"` takes every local device; a list is taken
as it is. With more than one device, `synthesize_batch` pads the batch to a
multiple of the device count and splits it by rows over one replica per
device (`parallel/serving.py::make_sharded_fused`); `synthesize` runs its one
item on the first device.

The compute dtype lives in the modules: `Synthesizer.from_checkpoint` builds
the acoustic model of `train.compute_dtype` (`VTTS.from_config`: bf16 FFT
stacks and PostNet) and `load_vocoder` the vocoder of `model.vocoder_kwargs`,
whose `dtype` ("bfloat16") reaches `get_vocoder` as the JAX Synthesizer's
kwargs reach its `get_vocoder`; the fused call and `vocode` take the mel and
return the waveform in fp32 whatever the dtypes.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from visual_onoma_to_wave_tpu_torch import tracing
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
    The vocoder runs through `vocode` (MelGAN is fed mel / ln 10). A
    generator with anti-aliased activation sites (BigVGAN) has them counted
    once a call from its route plan (`amp_site_plan`): `synth.amp_sites`
    through the one-pass kernel, `synth.amp_sites_plain` as modules. The
    acoustic model's conv FFN and PostNet convs are counted the same way
    (`acoustic_conv_plan`): `synth.acoustic_convs` on B7,
    `synth.acoustic_convs_plain` as modules."""
    plan = getattr(gen, "amp_site_plan", None)

    @torch.inference_mode()
    def fused(batch: dict, e_control=1.0, d_control=1.0) -> dict:
        with tracing.span("synth.acoustic"):
            kernel_convs, plain_convs = model.acoustic_conv_plan(batch["texts"].device)
            tracing.count("synth.acoustic_convs", kernel_convs)
            tracing.count("synth.acoustic_convs_plain", plain_convs)
            out = model(batch["audiotypes"], batch["texts"], batch["src_lens"],
                        image_cells=batch.get("image_cells"),
                        e_control=e_control, d_control=d_control)
        with tracing.span("synth.vocoder"):
            if plan is not None:       # BigVGAN: its activation sites by route, once a call
                fused_sites, plain_sites = plan(out["postnet_mel"].device)
                tracing.count("synth.amp_sites", fused_sites)
                tracing.count("synth.amp_sites_plain", plain_sites)
            wav = vocode(gen, out["postnet_mel"])
        return {**out, "wav": wav}

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


def to_device(arrays: dict, device: torch.device) -> dict:
    """numpy `arrays` copied to `device` as tensors, spanned as `synth.h2d`
    and counted (`synth.h2d_bytes`, the arrays' nbytes)."""
    with tracing.span("synth.h2d"):
        tracing.count("synth.h2d_bytes", sum(a.nbytes for a in arrays.values()))
        return {k: torch.from_numpy(np.ascontiguousarray(a)).to(device) for k, a in arrays.items()}


def to_host(out: dict) -> dict:
    """`out` with every tensor copied to a numpy array, spanned as
    `synth.d2h` and counted (`synth.d2h_bytes`, the arrays' nbytes)."""
    with tracing.span("synth.d2h"):
        copied = {k: v.cpu().numpy() for k, v in out.items() if isinstance(v, torch.Tensor)}
        tracing.count("synth.d2h_bytes", sum(v.nbytes for v in copied.values()))
    return {**out, **copied}


def resolve_device(device: str | torch.device) -> torch.device:
    """A torch.device; a CUDA device without CUDA raises (never drops to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        pin_fp32()
    return device


def serving_devices(device: str | torch.device, devices="auto") -> list[torch.device]:
    """The devices a Synthesizer serves on: "auto" is every visible card when
    `device` is a CUDA device and more than one is visible (as the JAX
    `mesh="auto"` takes every local device), else `[device]`; None is
    `[device]`; a list is taken as it is."""
    if devices is None:
        return [torch.device(device)]
    if isinstance(devices, str):
        if devices != "auto":
            raise ValueError(f"devices must be 'auto', None or a list, got {devices!r}")
        device = torch.device(device)
        if device.type == "cuda" and torch.cuda.is_available() and torch.cuda.device_count() > 1:
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [device]
    return [torch.device(d) for d in devices]


class Synthesizer:
    _sharded = None     # the runner over several devices (`make_sharded_fused`), if any

    def __init__(self, config, model: VTTS, metadata, symbol_map: dict[str, int],
                 vocoder=None, device: str | torch.device = "cuda",
                 devices: Optional[Sequence[str | torch.device]] = None):
        """config: a `config.Config`; model and vocoder (a generator module,
        or None for mel-only synthesis) hold their weights. `devices`: more
        than one shards `synthesize_batch` over them (the first is `device`'s
        replica when they are the same device)."""
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
        self.devices = [resolve_device(d) for d in devices] if devices else [self.device]
        if len(self.devices) > 1:
            from visual_onoma_to_wave_tpu_torch.parallel.serving import make_sharded_fused

            self._sharded = make_sharded_fused(self.model, self.vocoder, self.devices)

    @property
    def vocoder_params(self):
        """The generator's parameters (None without a vocoder); the reference
        server reads this to report whether audio is produced."""
        return None if self.vocoder is None else self.vocoder.state_dict()

    @classmethod
    def from_checkpoint(cls, config, acoustic: Optional[str] = None,
                        vocoder: Optional[str] = None, restore_step: Optional[int] = None,
                        device: str | torch.device = "cuda",
                        devices="auto") -> "Synthesizer":
        """Load the acoustic `.npz` tree `acoustic` (written by `cli
        convert-acoustic` or `examples/export_demo_for_torch.py`; it takes
        priority) or else the training checkpoint's
        `<path.ckpt>/<step>/acoustic.npz` at `restore_step` (None or -1: the
        latest; a missing step raises naming the directory), and the vocoder
        `.npz`. Metadata come from `config.path.preprocessed`; the vocabulary
        from the checkpoint's `symbols.json` first (the trainer writes it
        there), then the corpus's, then the corpus's split files, in the JAX
        Synthesizer's order. `devices`: "auto" (every visible card when
        `device` is a CUDA device and more than one is visible, else
        `device`), or a list taken as it is."""
        from visual_onoma_to_wave_tpu_torch.config import DatasetMetadata
        from visual_onoma_to_wave_tpu_torch.data.symbols import build_symbol_map, load_symbol_map
        from visual_onoma_to_wave_tpu_torch.utils.checkpoint import acoustic_path

        if acoustic is None:
            acoustic = str(acoustic_path(config.path.ckpt, restore_step))
        metadata = DatasetMetadata.load(config.path.preprocessed)
        symbol_map = (load_symbol_map(config.path.ckpt)
                      or load_symbol_map(config.path.preprocessed)
                      or build_symbol_map(config.path.preprocessed))
        model = VTTS.from_config(config, metadata, n_vocab=len(symbol_map))
        model.load_state_dict(vtts_state_dict(load_npz(acoustic)))
        gen = load_vocoder(config, vocoder) if vocoder is not None else None
        return cls(config, model, metadata, symbol_map, gen, device=device,
                   devices=serving_devices(device, devices))

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

    def _render_cells(self, text: str, width_rates: Sequence[float],
                      out: Optional[np.ndarray] = None) -> np.ndarray:
        """(n_chars, H, cell_width) float32 cells in [0, 1]. With `out` (the
        request's rows of the batch's cells) the cells are written there and
        the (H, n_chars * cell_width) uint8 strip they came from is returned:
        the request's image. Counts the renderer's cell lookups as
        `synth.glyph_hits` and `synth.glyph_misses` (cells it had to build)."""
        from visual_onoma_to_wave_tpu_torch.data.renderer import sized_cells_built

        built = sized_cells_built()
        strip = self.renderer.draw_with_width_rates(
            text, list(width_rates), cell_width=self.cell_width, grayscale=True)
        misses = sized_cells_built() - built
        tracing.count("synth.glyph_hits", min(len(text), len(width_rates)) - misses)
        tracing.count("synth.glyph_misses", misses)
        H = strip.shape[0]
        cells = strip.reshape(H, len(text), self.cell_width).transpose(1, 0, 2)
        if out is None:
            return cells.astype(np.float32) / 255.0
        np.divide(cells, 255, out=out, dtype=np.float32)
        return strip

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
        """(padded_batch, padded_text_len): batch to a power of two (then to a
        multiple of the device count), text length to a multiple of
        `text_bucket`."""
        return self._signature(texts, len(self.devices) if self._sharded is not None else 1)

    def _signature(self, texts: Sequence[str], n_devices: int) -> tuple[int, int]:
        b_pad = max(1, 1 << (len(texts) - 1).bit_length())
        b_pad = -(-b_pad // n_devices) * n_devices
        n_max = max(len(t) for t in texts)
        return b_pad, -(-n_max // self.text_bucket) * self.text_bucket

    @contextlib.contextmanager
    def _locked(self):
        """`self._lock` held, the wait for it spanned as `synth.lock_wait`."""
        with tracing.span("synth.lock_wait"):
            self._lock.acquire()
        try:
            yield
        finally:
            self._lock.release()

    def _run(self, batch: dict, e_ctl: np.ndarray, d_ctl: np.ndarray) -> dict:
        batch = to_device({**batch, "e_control": e_ctl, "d_control": d_ctl}, self.device)
        e_ctl, d_ctl = batch.pop("e_control"), batch.pop("d_control")
        with self._locked():
            with tracing.span("synth.fused"):
                if self._fused is not None:
                    out = self._fused(batch, e_control=e_ctl, d_control=d_ctl)
                else:
                    with torch.inference_mode():
                        out = self.model(batch["audiotypes"], batch["texts"], batch["src_lens"],
                                         image_cells=batch.get("image_cells"),
                                         e_control=e_ctl, d_control=d_ctl)
            return to_host(out)

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
        result = self._synthesize_batch([text], [audiotype], [width_rates], e_control,
                                        d_control, return_mel=True, sharded=False)[0]
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
        per-item sequences. return_mel=False leaves `mel` None. Over several
        devices the padded batch is split by rows over them."""
        return self._synthesize_batch(texts, audiotypes, width_rates, e_control, d_control,
                                      return_mel, sharded=self._sharded is not None)

    def _synthesize_batch(self, texts, audiotypes, width_rates, e_control, d_control,
                          return_mel: bool, sharded: bool) -> list[SynthesisResult]:
        call = tracing.new_call()
        with tracing.span("synth.batch", call=call):
            if len(texts) != len(audiotypes):
                raise ValueError(f"{len(texts)} texts but {len(audiotypes)} audiotypes")
            texts = [self._clean_text(t) for t in texts]
            bsz = len(texts)
            width_rates = [None] * bsz if width_rates is None else width_rates
            self._check_controls(e_control, d_control)
            for wr in width_rates:
                if wr is not None:
                    self._check_controls(1.0, 1.0, wr)
            b_pad, C = self._signature(texts, len(self.devices) if sharded else 1)

            with tracing.span("synth.pad"):
                ids = np.zeros((b_pad,), np.int32)
                text_ids = np.zeros((b_pad, C), np.int32)
                src_lens = np.ones((b_pad,), np.int32)
                cells = np.ones((b_pad, C, self.metadata.image_height, self.cell_width),
                                np.float32)

                def column(v) -> np.ndarray:
                    col = np.ones((b_pad,), np.float32)
                    col[:bsz] = np.asarray(v, np.float32)
                    return col

                e_col, d_col = column(e_control), column(d_control)

            with tracing.span("synth.render"):
                images = []
                for i, (text, at) in enumerate(zip(texts, audiotypes)):
                    with tracing.span("synth.render_one", req=(call, i), ranged=False):
                        ids[i] = self._audiotype_id(at)
                        n = len(text)
                        src_lens[i] = n
                        text_ids[i, :n] = self._encode(text)
                        if self.use_image:
                            images.append(self._render_cells(
                                text, width_rates[i] or [1.0] * n, out=cells[i, :n]))
                        else:
                            images.append(None)
            batch = {"audiotypes": ids, "texts": text_ids, "src_lens": src_lens}
            if self.use_image:
                batch["image_cells"] = cells
            tracing.count("synth.rows", bsz)
            tracing.count("synth.rows_padded", b_pad)
            tracing.count("synth.chars", sum(len(t) for t in texts))
            tracing.count("synth.chars_padded", b_pad * C)

            if sharded:
                with self._locked(), tracing.span("synth.fused"):
                    out = self._sharded(batch, e_control=e_col, d_control=d_col)
            else:
                out = self._run(batch, e_col, d_col)

            with tracing.span("synth.slice"):
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
                tracing.count("synth.frames", sum(r.mel_len for r in results))
                if "wav" in out:   # every row vocoded, at the mel buffer's length
                    rows_v, frames_v = out["postnet_mel"].shape[:2]
                    tracing.count("synth.frames_vocoded", rows_v * frames_v)
            return results
