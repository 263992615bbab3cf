"""Vocoder family dispatch (port of visual_onoma_to_wave_tpu/models/vocoder.py).

Only the HiFi-GAN family is ported so far; the other families of the
reference raise `NotImplementedError` naming their ROADMAP item.
"""
from __future__ import annotations

from visual_onoma_to_wave_tpu_torch.models.hifigan import HIFIGAN_PRESETS, HiFiGANGenerator

_NOT_PORTED = {
    "melgan": "ROADMAP A8 (vocoder families: MelGAN)",
    "istftnet": "ROADMAP A8 (vocoder families: iSTFTNet)",
    "istftnetmel": "ROADMAP A8 (vocoder families: iSTFTNet-mel)",
    "vocos": "ROADMAP A8 (vocoder families: Vocos) and B4/B5 (ConvNeXt kernels)",
    "bigvgan": "ROADMAP A8 (vocoder families: BigVGAN)",
    "bigvganbase": "ROADMAP A8 (vocoder families: BigVGAN)",
    "bigvganlarge": "ROADMAP A8 (vocoder families: BigVGAN)",
}


def get_vocoder(model: str = "HiFi-GAN", **kwargs) -> HiFiGANGenerator:
    """Build the configured generator; explicit kwargs override the preset."""
    name = model.lower().replace("-", "").replace("_", "")
    if name in ("hifigan", "hifiganv1", "hifiganv2", "hifiganv3"):
        preset = dict(HIFIGAN_PRESETS[name[-2:] if name != "hifigan" else "v1"])
        preset.update(kwargs)
        return HiFiGANGenerator(**preset)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"vocoder family {model!r} is not ported to PyTorch yet: {_NOT_PORTED[name]}")
    raise ValueError(f"unknown vocoder family: {model!r}")
