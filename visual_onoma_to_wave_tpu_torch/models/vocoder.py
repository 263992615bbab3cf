"""Vocoder family dispatch (port of visual_onoma_to_wave_tpu/models/vocoder.py).

HiFi-GAN (V1/V2/V3), MelGAN, iSTFTNet (C8C8I), iSTFTNet-mel (melrate) and
Vocos are ported; BigVGAN raises `NotImplementedError` naming its ROADMAP
item.
"""
from __future__ import annotations

from torch import nn

from visual_onoma_to_wave_tpu_torch.models.hifigan import HIFIGAN_PRESETS, HiFiGANGenerator
from visual_onoma_to_wave_tpu_torch.models.istftnet import build_istftnet
from visual_onoma_to_wave_tpu_torch.models.melgan import MelGANGenerator
from visual_onoma_to_wave_tpu_torch.models.vocos import VocosGenerator

_NOT_PORTED = {
    "bigvgan": "ROADMAP A8 (vocoder families: BigVGAN)",
    "bigvganbase": "ROADMAP A8 (vocoder families: BigVGAN)",
    "bigvganlarge": "ROADMAP A8 (vocoder families: BigVGAN)",
}
# Vocos keys of the reference's config that select TPU serving options; the
# port always runs its ConvNeXt kernel on the card and its iSTFT product in
# IEEE fp32, at least as exact as either TPU setting
_VOCOS_TPU_KEYS = ("fused_kernel", "head_precision")


def family(model: str) -> str:
    """The normalised family name: 'HiFi-GAN_v1' -> 'hifiganv1'."""
    return model.lower().replace("-", "").replace("_", "")


def get_vocoder(model: str = "HiFi-GAN", **kwargs) -> nn.Module:
    """Build the configured generator; explicit kwargs override the preset.
    For Vocos, `fused_kernel` and `head_precision` are accepted and not
    passed on (the port has one serving form: kernel on the card, fp32 head)."""
    name = family(model)
    if name in ("hifigan", "hifiganv1", "hifiganv2", "hifiganv3"):
        preset = dict(HIFIGAN_PRESETS[name[-2:] if name != "hifigan" else "v1"])
        preset.update(kwargs)
        return HiFiGANGenerator(**preset)
    if name == "melgan":
        return MelGANGenerator(**kwargs)
    if name in ("istftnet", "istftnetmel"):
        return build_istftnet("melrate" if name == "istftnetmel" else "c8c8i", **kwargs)
    if name == "vocos":
        return VocosGenerator(**{k: v for k, v in kwargs.items() if k not in _VOCOS_TPU_KEYS})
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"vocoder family {model!r} is not ported to PyTorch yet: {_NOT_PORTED[name]}")
    raise ValueError(f"unknown vocoder family: {model!r}")
