"""FastSpeech2 loss (port of visual_onoma_to_wave_tpu/training/loss.py).

Masked MAE for mel and PostNet mel, masked MSE for the character-level
energy, kurtosis and log-duration: each a masked mean (sum of the masked
errors over their count), as the reference computes it. Under data
parallelism over processes (`global_counts=True`) each process holds its
rows of a global batch: the count is all-reduced, so each process's losses
are its share of the global batch's, and their sum over the processes is
the one-process loss.
"""
from __future__ import annotations

import torch


def _masked_mean(err: torch.Tensor, valid: torch.Tensor,
                 global_counts: bool = False) -> torch.Tensor:
    valid = valid.to(err.dtype)
    count = torch.sum(valid)
    if global_counts:
        import torch.distributed as dist

        count = count.detach().clone()
        dist.all_reduce(count)
    return torch.sum(err * valid) / torch.clamp(count, min=1.0)


def fastspeech2_loss(outputs: dict, batch: dict, global_counts: bool = False) -> dict:
    """The six losses of one batch.

    outputs: the `VTTS` output dict; batch: 'mels' (B, T, n_mels),
    'durations' (B, C), and 'energies' / 'kurtoses' (B, C) when present.
    global_counts: divide by the valid counts of all processes (module
    docstring).
    """
    def mean(err, valid):
        return _masked_mean(err, valid, global_counts)

    src_valid = ~outputs["src_pad_mask"]
    mel_valid = ~outputs["mel_pad_mask"]

    mel_t = batch["mels"]
    n_mels = mel_t.shape[-1]
    mel_loss = mean(torch.sum(torch.abs(outputs["mel"] - mel_t), dim=-1), mel_valid) / n_mels
    postnet_mel_loss = mean(
        torch.sum(torch.abs(outputs["postnet_mel"] - mel_t), dim=-1), mel_valid) / n_mels

    log_d_target = torch.log(batch["durations"].float() + 1.0)
    duration_loss = mean((outputs["log_duration_pred"] - log_d_target) ** 2, src_valid)

    zero = torch.zeros((), dtype=mel_loss.dtype, device=mel_loss.device)
    energy_loss = kurtosis_loss = zero
    if outputs["energy_pred"] is not None and batch.get("energies") is not None:
        energy_loss = mean((outputs["energy_pred"] - batch["energies"]) ** 2, src_valid)
    if outputs["kurtosis_pred"] is not None and batch.get("kurtoses") is not None:
        kurtosis_loss = mean((outputs["kurtosis_pred"] - batch["kurtoses"]) ** 2, src_valid)

    total = mel_loss + postnet_mel_loss + duration_loss + energy_loss + kurtosis_loss
    return {
        "total_loss": total,
        "mel_loss": mel_loss,
        "postnet_mel_loss": postnet_mel_loss,
        "energy_loss": energy_loss,
        "kurtosis_loss": kurtosis_loss,
        "duration_loss": duration_loss,
    }
