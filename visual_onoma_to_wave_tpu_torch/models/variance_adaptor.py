"""Variance adaptor (port of visual_onoma_to_wave_tpu/models/variance_adaptor.py).

Duration / energy / kurtosis prediction, bucketize-embed and the length
regulator. With targets (teacher forcing, training and the eval step) the
energy and kurtosis targets are embedded in place of the predictions and the
duration targets drive the length regulator; without them the controlled
predictions are. `torch.bucketize(v, bins, right=False)` is the reference's
`searchsorted(bins, v, side='left')`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from visual_onoma_to_wave_tpu_torch.models.layers import VariancePredictor
from visual_onoma_to_wave_tpu_torch.ops.length_regulator import (
    get_mask_from_lengths,
    length_regulate,
)


def _make_bins(vmin: float, vmax: float, n_bins: int, quantization: str) -> np.ndarray:
    if quantization == "log":
        return np.exp(np.linspace(np.log(vmin), np.log(vmax), n_bins - 1)).astype(np.float32)
    return np.linspace(vmin, vmax, n_bins - 1).astype(np.float32)


def _control_column(c, device: torch.device):
    """A scalar control, or a per-item (B,) / (B, 1) one as a (B, 1) column."""
    if isinstance(c, (int, float)):
        return c
    c = torch.as_tensor(c, dtype=torch.float32, device=device)
    return c[:, None] if c.ndim == 1 else c


class VarianceAdaptor(nn.Module):
    def __init__(self, hidden: int = 256, n_bins: int = 256, filter_size: int = 256,
                 kernel_size: int = 3, is_energy: bool = True, is_kurtosis: bool = False,
                 energy_quantization: str = "linear", kurtosis_quantization: str = "linear",
                 energy_stats=(-1.0, 1.0, 0.0, 1.0), kurtosis_stats=(-1.0, 1.0, 0.0, 1.0),
                 max_mel_len: int = 1000, dropout: float = 0.5):
        super().__init__()
        self.max_mel_len = max_mel_len
        self.duration_predictor = VariancePredictor(hidden, filter_size, kernel_size, dropout)
        self.energy_stats = tuple(energy_stats)
        self.kurtosis_stats = tuple(kurtosis_stats)
        self.is_energy, self.is_kurtosis = is_energy, is_kurtosis
        if is_energy:
            self.energy_predictor = VariancePredictor(hidden, filter_size, kernel_size, dropout)
            self.energy_embedding = nn.Embedding(n_bins, hidden)
            self.register_buffer("energy_bins", torch.from_numpy(_make_bins(
                energy_stats[0], energy_stats[1], n_bins, energy_quantization)),
                persistent=False)
        if is_kurtosis:
            self.kurtosis_predictor = VariancePredictor(hidden, filter_size, kernel_size,
                                                        dropout)
            self.kurt_embedding = nn.Embedding(n_bins, hidden)
            self.register_buffer("kurt_bins", torch.from_numpy(_make_bins(
                kurtosis_stats[0], kurtosis_stats[1], n_bins, kurtosis_quantization)),
                persistent=False)

    @staticmethod
    def _variance_embedding(predictor, embedding, bins, mean, std, x, target, pad_mask,
                            control):
        """Embed the target when given; else de-normalize the prediction, scale
        it by the control, re-normalize, bucketize and embed (reference order
        of operations)."""
        prediction = predictor(x, pad_mask)
        if target is not None:
            return prediction, embedding(torch.bucketize(target, bins, right=False))
        p = prediction * std + mean
        p = p * control
        prediction = (p - mean) / std
        return prediction, embedding(torch.bucketize(prediction, bins, right=False))

    def forward(self, x: torch.Tensor, src_pad_mask: torch.Tensor,
                e_control=1.0, d_control=1.0, max_mel_len: int | None = None,
                energy_target: torch.Tensor | None = None,
                kurtosis_target: torch.Tensor | None = None,
                duration_target: torch.Tensor | None = None):
        """x: (B, C, D) encoder output; src_pad_mask: (B, C) True = padding;
        targets (B, C) or None (durations as integer frame counts).

        Returns (x, energy_pred, kurtosis_pred, log_duration_pred,
        duration_rounded, mel_len, mel_pad_mask), x at (B, max_mel_len, D).
        """
        max_mel_len = max_mel_len or self.max_mel_len
        e_control = _control_column(e_control, x.device)
        d_control = _control_column(d_control, x.device)
        log_duration_prediction = self.duration_predictor(x, src_pad_mask)

        energy_prediction = None
        if self.is_energy:
            energy_prediction, emb = self._variance_embedding(
                self.energy_predictor, self.energy_embedding, self.energy_bins,
                self.energy_stats[2], self.energy_stats[3], x, energy_target, src_pad_mask,
                e_control)
            x = x + emb
        kurtosis_prediction = None
        if self.is_kurtosis:
            kurtosis_prediction, emb = self._variance_embedding(
                self.kurtosis_predictor, self.kurt_embedding, self.kurt_bins,
                self.kurtosis_stats[2], self.kurtosis_stats[3], x, kurtosis_target, src_pad_mask,
                1.0)
            x = x + emb

        if duration_target is not None:
            duration_rounded = duration_target
        else:
            # clamp(round(exp(log_d) - 1) * d_control, min=0); round() is half
            # to even in both frameworks, and padding rows give 0
            duration_rounded = torch.clamp(
                torch.round(torch.exp(log_duration_prediction) - 1.0) * d_control, min=0.0)
            duration_rounded = duration_rounded.masked_fill(src_pad_mask, 0.0)
        x, mel_len = length_regulate(x, duration_rounded.to(torch.int32), max_mel_len)
        mel_pad_mask = get_mask_from_lengths(mel_len, max_mel_len)
        return (x, energy_prediction, kurtosis_prediction, log_duration_prediction,
                duration_rounded, mel_len, mel_pad_mask)
