"""FastSpeech2 loss (port of visual_onoma_to_wave_tpu/training/loss.py).

Masked MAE for mel and PostNet mel, masked MSE for the character-level
energy, kurtosis and log-duration: each a masked mean (sum of the masked
errors over their count), as the reference computes it.
"""
from __future__ import annotations

import torch


def _masked_mean(err: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    valid = valid.to(err.dtype)
    return torch.sum(err * valid) / torch.clamp(torch.sum(valid), min=1.0)


def fastspeech2_loss(outputs: dict, batch: dict) -> dict:
    """The six losses of one batch.

    outputs: the `VTTS` output dict; batch: 'mels' (B, T, n_mels),
    'durations' (B, C), and 'energies' / 'kurtoses' (B, C) when present.
    """
    src_valid = ~outputs["src_pad_mask"]
    mel_valid = ~outputs["mel_pad_mask"]

    mel_t = batch["mels"]
    n_mels = mel_t.shape[-1]
    mel_loss = _masked_mean(torch.sum(torch.abs(outputs["mel"] - mel_t), dim=-1),
                            mel_valid) / n_mels
    postnet_mel_loss = _masked_mean(
        torch.sum(torch.abs(outputs["postnet_mel"] - mel_t), dim=-1), mel_valid) / n_mels

    log_d_target = torch.log(batch["durations"].float() + 1.0)
    duration_loss = _masked_mean((outputs["log_duration_pred"] - log_d_target) ** 2, src_valid)

    zero = torch.zeros((), dtype=mel_loss.dtype, device=mel_loss.device)
    energy_loss = kurtosis_loss = zero
    if outputs["energy_pred"] is not None and batch.get("energies") is not None:
        energy_loss = _masked_mean((outputs["energy_pred"] - batch["energies"]) ** 2, src_valid)
    if outputs["kurtosis_pred"] is not None and batch.get("kurtoses") is not None:
        kurtosis_loss = _masked_mean((outputs["kurtosis_pred"] - batch["kurtoses"]) ** 2,
                                     src_valid)

    total = mel_loss + postnet_mel_loss + duration_loss + energy_loss + kurtosis_loss
    return {
        "total_loss": total,
        "mel_loss": mel_loss,
        "postnet_mel_loss": postnet_mel_loss,
        "energy_loss": energy_loss,
        "kurtosis_loss": kurtosis_loss,
        "duration_loss": duration_loss,
    }
