"""Vocoder family dispatch (port of visual_onoma_to_wave_tpu/models/vocoder.py
and the inference entry of models/hifigan.py).

Every family of the reference is ported: HiFi-GAN (V1/V2/V3), MelGAN,
iSTFTNet (C8C8I), iSTFTNet-mel (melrate), Vocos and BigVGAN (base, large).
`vocoder_infer` is the one mel -> waveform call for all of them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from visual_onoma_to_wave_tpu_torch.models.bigvgan import BIGVGAN_PRESETS, BigVGANGenerator
from visual_onoma_to_wave_tpu_torch.models.hifigan import HIFIGAN_PRESETS, HiFiGANGenerator
from visual_onoma_to_wave_tpu_torch.models.istftnet import build_istftnet
from visual_onoma_to_wave_tpu_torch.models.melgan import LN10, MelGANGenerator
from visual_onoma_to_wave_tpu_torch.models.vocos import VocosGenerator
from visual_onoma_to_wave_tpu_torch.precision import compute_dtype

# Vocos keys of the reference's config that select TPU serving options; the
# port always runs its ConvNeXt kernel on the card and its iSTFT product in
# IEEE fp32, at least as exact as either TPU setting
_VOCOS_TPU_KEYS = ("fused_kernel", "head_precision")


def family(model: str) -> str:
    """The normalised family name: 'HiFi-GAN_v1' -> 'hifiganv1'."""
    return model.lower().replace("-", "").replace("_", "")


def get_vocoder(model: str = "HiFi-GAN", *, dtype=torch.float32, **kwargs) -> nn.Module:
    """Build the configured generator; explicit kwargs override the preset.
    `dtype` is the compute dtype (torch.bfloat16 or "bfloat16" / "bf16" for
    bf16, `precision.compute_dtype`) of every family but MelGAN, which
    ignores it, as the JAX package's `get_vocoder` builds MelGAN without one.
    For Vocos, `fused_kernel` and `head_precision` are accepted and not
    passed on (the port has one serving form: kernel on the card, fp32 head)."""
    name = family(model)
    dtype = compute_dtype(dtype)
    if name in ("hifigan", "hifiganv1", "hifiganv2", "hifiganv3"):
        preset = dict(HIFIGAN_PRESETS[name[-2:] if name != "hifigan" else "v1"])
        preset.update(kwargs)
        return HiFiGANGenerator(dtype=dtype, **preset)
    if name == "melgan":
        return MelGANGenerator(**kwargs)
    if name in ("istftnet", "istftnetmel"):
        return build_istftnet("melrate" if name == "istftnetmel" else "c8c8i", dtype=dtype,
                              **kwargs)
    if name == "vocos":
        return VocosGenerator(dtype=dtype, **{k: v for k, v in kwargs.items()
                                              if k not in _VOCOS_TPU_KEYS})
    if name in ("bigvgan", "bigvganbase", "bigvganlarge"):
        preset = dict(BIGVGAN_PRESETS["large" if name.endswith("large") else "base"])
        preset.update(kwargs)
        return BigVGANGenerator(dtype=dtype, **preset)
    raise ValueError(f"unknown vocoder family: {model!r}")


def generate(gen: nn.Module, mels: torch.Tensor) -> torch.Tensor:
    """(B, T, n_mels) natural-log mels -> (B, T * hop) waveforms. A MelGAN
    generator takes log10 mels, so it is fed mel / ln 10."""
    return gen(mels / LN10 if isinstance(gen, MelGANGenerator) else mels)


def vocoder_infer(gen: nn.Module, mels: torch.Tensor, lengths=None,
                  hop_length: int = 256) -> tuple[torch.Tensor, np.ndarray]:
    """(B, T, n_mels) natural-log mels -> (waveforms (B, T * hop) by
    `generate`, each item's sample count: lengths x hop_length, or the whole
    width without lengths)."""
    wavs = generate(gen, mels)
    if lengths is not None:
        sample_lens = np.asarray(lengths) * hop_length
    else:
        sample_lens = np.full((mels.shape[0],), wavs.shape[1])
    return wavs, sample_lens
