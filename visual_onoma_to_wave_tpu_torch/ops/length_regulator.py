"""Vectorized length regulator (port of visual_onoma_to_wave_tpu/ops/length_regulator.py).

One fixed-size gather instead of a per-item loop:

    frame_to_char[t] = searchsorted(cumsum(durations), t, right=True)
    out[t] = x[frame_to_char[t]]     (0 for t >= sum(durations))
"""
from __future__ import annotations

import torch


def length_regulate(x: torch.Tensor, durations: torch.Tensor,
                    max_mel_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Expand (B, C, D) character features to (B, max_mel_len, D) frames.

    durations: (B, C) integer frame counts (zero-padded). Returns the frames
    (zero beyond each item's total) and mel_len = min(sum(durations), max_mel_len).
    """
    B, _, D = x.shape
    bounds = torch.cumsum(durations.long(), dim=-1)                # (B, C)
    total = bounds[:, -1]
    frame_idx = torch.arange(max_mel_len, device=x.device)
    char_idx = torch.searchsorted(bounds, frame_idx.expand(B, -1).contiguous(),
                                  right=True)                      # (B, T)
    valid = frame_idx[None, :] < total[:, None]
    char_idx = torch.where(valid, char_idx, 0)
    out = torch.gather(x, 1, char_idx[:, :, None].expand(B, max_mel_len, D))
    out = out.masked_fill(~valid[:, :, None], 0.0)
    mel_len = torch.clamp(total, max=max_mel_len).to(torch.int32)
    return out, mel_len


def get_mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Padding mask: True where position >= length."""
    ids = torch.arange(max_len, device=lengths.device)
    return ids[None, :] >= lengths[:, None]


def expand_char_to_frame(values: torch.Tensor, durations: torch.Tensor,
                         max_len: int) -> torch.Tensor:
    """(C,) per-character values -> (max_len,) frame values (0 beyond the total)."""
    bounds = torch.cumsum(durations.long(), dim=0)
    frame_idx = torch.arange(max_len, device=values.device)
    char_idx = torch.searchsorted(bounds, frame_idx, right=True)
    valid = frame_idx < bounds[-1]
    char_idx = torch.where(valid, char_idx, 0)
    return torch.where(valid, values[char_idx], 0.0)
