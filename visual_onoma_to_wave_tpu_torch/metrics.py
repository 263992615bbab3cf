"""Objective synthesis-quality metrics: mel-cepstral distortion + mel L1
(copy of visual_onoma_to_wave_tpu/metrics.py).

The reference's only quality signal is human TensorBoard listening
(reference scripts/evaluate.py:58-103 logs audio pairs for a person to
judge); these give "matches the reference" a machine-checkable number.

Two alignment regimes, both reported by `Trainer.evaluate(metrics=True)`
(`cli evaluate --metrics`):

* teacher-forced — the model is driven by ground-truth durations (the
  eval_step forward), so predicted and target mels are frame-aligned and
  compare directly;
* free-running — the model predicts its own durations (the synth_step
  forward), lengths differ, and frames are aligned by dynamic time
  warping on the cepstral distance matrix (the standard TTS evaluation
  protocol, Kubichek 1993).

MCD here is the mel-spectral variant: cepstra are an orthonormal DCT-II
of the natural-log mel spectrogram along the mel axis, coefficients 1..13
(c0 = loudness, excluded), distortion
    MCD = (10 / ln 10) * sqrt(2) * mean_t ||c_pred(t) - c_gt(t)||_2   [dB].

Everything is plain numpy on purpose: the val split is small, DTW is a
sequential DP, and keeping it off-device means the metric also works on
mels loaded from disk with no model in memory. The DTW recursion runs in
the host C kernel (`data/native.py`, the JAX package's `datakernels.c`)
when a C compiler builds it, as the JAX package runs it; `dtw_path`, its
numpy twin, fills it by anti-diagonals with the same sums, moves and
tie-breaking, and runs where no compiler is found.
"""
from __future__ import annotations

import numpy as np

# Kubichek (1993): 10/ln10 * sqrt(2) converts a natural-log cepstral
# Euclidean distance to dB
MCD_K = 10.0 / np.log(10.0) * np.sqrt(2.0)


def _dct_matrix(n_mels: int, n_coeffs: int) -> np.ndarray:
    """Orthonormal DCT-II basis rows 0..n_coeffs (inclusive of c0)."""
    k = np.arange(n_coeffs + 1)[:, None]
    m = np.arange(n_mels)[None, :]
    basis = np.cos(np.pi * k * (2 * m + 1) / (2 * n_mels))
    basis *= np.sqrt(2.0 / n_mels)
    basis[0] *= np.sqrt(0.5)
    return basis  # (n_coeffs+1, n_mels)


def mel_cepstra(logmel: np.ndarray, n_coeffs: int = 13) -> np.ndarray:
    """(T, M) natural-log mel -> (T, n_coeffs) cepstra c1..c_n (c0 dropped)."""
    logmel = np.asarray(logmel, np.float64)
    basis = _dct_matrix(logmel.shape[-1], n_coeffs)
    return logmel @ basis[1:].T


def mcd_frames(pred_logmel: np.ndarray, gt_logmel: np.ndarray,
               n_coeffs: int = 13) -> float:
    """Frame-aligned MCD in dB between two (T, M) log-mels (teacher-forced
    regime: both driven by the same durations, so T matches)."""
    if pred_logmel.shape != gt_logmel.shape:
        raise ValueError(
            f"frame-aligned MCD needs equal shapes, got "
            f"{pred_logmel.shape} vs {gt_logmel.shape}; use mcd_dtw for "
            f"free-running mels")
    cp = mel_cepstra(pred_logmel, n_coeffs)
    cg = mel_cepstra(gt_logmel, n_coeffs)
    return float(MCD_K * np.mean(np.linalg.norm(cp - cg, axis=-1)))


def dtw_path(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Monotone alignment path minimizing total cost over steps
    (1,0),(0,1),(1,1). Returns (path_i, path_j) index arrays.

    acc[i, j] = cost[i-1, j-1] + min(acc[i-1, j], acc[i, j-1], acc[i-1, j-1])
    depends only on the previous two anti-diagonals, so each anti-diagonal
    is one vectorised step (the same float64 sums as the row loop)."""
    T1, T2 = cost.shape
    acc = np.full((T1 + 1, T2 + 1), np.inf)
    acc[0, 0] = 0.0
    for d in range(2, T1 + T2 + 1):
        i = np.arange(max(1, d - T2), min(T1, d - 1) + 1)
        j = d - i
        acc[i, j] = cost[i - 1, j - 1] + np.minimum(
            np.minimum(acc[i - 1, j], acc[i, j - 1]), acc[i - 1, j - 1])
    i, j = T1, T2
    pi, pj = [], []
    while i > 0 and j > 0:
        pi.append(i - 1)
        pj.append(j - 1)
        moves = (acc[i - 1, j - 1], acc[i - 1, j], acc[i, j - 1])
        m = int(np.argmin(moves))
        if m == 0:
            i, j = i - 1, j - 1
        elif m == 1:
            i -= 1
        else:
            j -= 1
    return np.asarray(pi[::-1]), np.asarray(pj[::-1])


def _dtw(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The DTW path through the C kernel, or `dtw_path` without a C compiler."""
    from visual_onoma_to_wave_tpu_torch.data import native

    return native.dtw_path_f64(cost) if native.available() else dtw_path(cost)


def mcd_dtw(pred_logmel: np.ndarray, gt_logmel: np.ndarray,
            n_coeffs: int = 13) -> float:
    """DTW-aligned MCD in dB between (T1, M) and (T2, M) log-mels
    (free-running regime: predicted durations, lengths differ)."""
    cp = mel_cepstra(pred_logmel, n_coeffs)
    cg = mel_cepstra(gt_logmel, n_coeffs)
    if cp.shape[0] == 0 or cg.shape[0] == 0:
        # same behavior on both DP paths (the C kernel rejects degenerate
        # sizes; the Python DP would silently mean an empty path into NaN)
        raise ValueError(
            f"mcd_dtw needs at least one frame per side, got "
            f"{pred_logmel.shape} vs {gt_logmel.shape}")
    # pairwise Euclidean distances (T1, T2)
    d2 = (np.sum(cp**2, -1)[:, None] + np.sum(cg**2, -1)[None, :]
          - 2.0 * (cp @ cg.T))
    dist = np.sqrt(np.maximum(d2, 0.0))
    pi, pj = _dtw(dist)
    return float(MCD_K * np.mean(dist[pi, pj]))


def mel_l1(pred_logmel: np.ndarray, gt_logmel: np.ndarray) -> float:
    """Mean absolute error between frame-aligned (T, M) log-mels."""
    if pred_logmel.shape != gt_logmel.shape:
        raise ValueError(
            f"mel L1 needs equal shapes, got {pred_logmel.shape} vs "
            f"{gt_logmel.shape}")
    return float(np.mean(np.abs(np.asarray(pred_logmel, np.float64)
                                - np.asarray(gt_logmel, np.float64))))


# ---------------------------------------------------------------------------
# Waveform-domain quality: multi-resolution STFT distance
# ---------------------------------------------------------------------------
# The mel-domain metrics above share a structural bias with the iSTFT-head
# vocoder families (they regress magnitude spectra directly, so mel metrics
# favor them — BASELINE.md's own caveat). The multi-resolution STFT distance
# (Yamamoto et al. 2020, Parallel WaveGAN, eqs. 4-6) compares the WAVEFORMS:
# spectral convergence + log-magnitude L1 at several analysis resolutions.
# Phase errors de-cohere the waveform and smear magnitude at the finer
# resolutions, so it penalizes exactly what single-resolution mel metrics
# can hide. The reference has no waveform metric at all (its evaluate.py
# logs audio for human listening).

# (n_fft, hop, win_length) triples — the standard PWG/auraloss set
MRSTFT_RESOLUTIONS = ((512, 128, 512), (1024, 256, 1024), (2048, 512, 2048))
_LOG_EPS = 1e-7


def stft_magnitude(wav: np.ndarray, n_fft: int, hop: int,
                   win_length: int) -> np.ndarray:
    """(N,) waveform -> (T, n_fft//2+1) STFT magnitude, torch.stft-compatible
    (center=True reflect pad, periodic Hann, float64 accumulation)."""
    wav = np.asarray(wav, np.float64)
    n = np.arange(win_length, dtype=np.float64)
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)  # periodic Hann
    if win_length < n_fft:  # center the window in the frame like torch
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    pad = n_fft // 2
    x = np.pad(wav, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    return np.abs(np.fft.rfft(x[idx] * win, axis=-1))


def mrstft_distance(pred_wav: np.ndarray, gt_wav: np.ndarray,
                    resolutions=MRSTFT_RESOLUTIONS) -> dict[str, float]:
    """Multi-resolution STFT distance between two waveforms.

    Returns {"sc": .., "mag": .., "total": ..} where per resolution
      sc  = ||S_gt - S_pred||_F / ||S_gt||_F      (spectral convergence)
      mag = mean |log S_pred - log S_gt|          (log-magnitude L1, nats)
    averaged over resolutions; total = sc + mag (the PWG loss convention).
    Lengths may differ by a few samples (codec/hop slop): both are trimmed
    to the shorter; a >10% mismatch raises (that is an alignment bug, not
    slop)."""
    pred_wav = np.asarray(pred_wav, np.float64).reshape(-1)
    gt_wav = np.asarray(gt_wav, np.float64).reshape(-1)
    n = min(len(pred_wav), len(gt_wav))
    if n == 0:
        raise ValueError("mrstft_distance needs non-empty waveforms")
    if max(len(pred_wav), len(gt_wav)) > int(n * 1.1) + 16:
        raise ValueError(
            f"waveform lengths differ too much to be hop slop: "
            f"{len(pred_wav)} vs {len(gt_wav)}; align them first")
    pred_wav, gt_wav = pred_wav[:n], gt_wav[:n]
    scs, mags = [], []
    for n_fft, hop, win_length in resolutions:
        sp = stft_magnitude(pred_wav, n_fft, hop, win_length)
        sg = stft_magnitude(gt_wav, n_fft, hop, win_length)
        denom = max(float(np.linalg.norm(sg)), _LOG_EPS)
        scs.append(float(np.linalg.norm(sg - sp)) / denom)
        mags.append(float(np.mean(np.abs(
            np.log(np.maximum(sp, _LOG_EPS))
            - np.log(np.maximum(sg, _LOG_EPS))))))
    sc, mag = float(np.mean(scs)), float(np.mean(mags))
    return {"sc": sc, "mag": mag, "total": sc + mag}


# a ground-truth frame counts as voiced when its mean log-mel sits this
# far (nats) above the corpus dynamic-range floor ln(1e-5) — the margin
# rejects pure-floor silence while keeping quiet decays
VOICED_MARGIN = 0.5
MEL_FLOOR = float(np.log(1e-5))


def voiced_mask(gt_logmel: np.ndarray, margin: float = VOICED_MARGIN
                ) -> np.ndarray:
    """(T,) bool: frames whose GT mean log-mel is above floor+margin.
    Silence frames sit at the ln(1e-5) clamp and dominate plain MCD on
    percussive material (most of a drum hit's timeline is decay/floor);
    the voiced variant scores only frames carrying signal."""
    return np.asarray(gt_logmel, np.float64).mean(-1) > MEL_FLOOR + margin


def batch_quality_metrics(tf_mels: np.ndarray, fr_mels: np.ndarray,
                          fr_lens: np.ndarray, gt_mels: np.ndarray,
                          gt_lens: np.ndarray) -> dict[str, float]:
    """Per-batch sums for the quality metrics (caller divides by n).

    tf_mels: (B, T, M) teacher-forced predictions (frame-aligned to gt);
    fr_mels/fr_lens: free-running predictions + their predicted lengths;
    gt_mels/gt_lens: targets. All padded; lengths mask the real frames.

    mcd_voiced restricts the teacher-forced MCD to voiced GT frames
    (voiced_mask); items with no voiced frames contribute their all-frame
    MCD instead (never NaN).
    """
    sums = {"mel_l1": 0.0, "mcd": 0.0, "mcd_voiced": 0.0, "mcd_dtw": 0.0}
    B = gt_mels.shape[0]
    for b in range(B):
        L = int(gt_lens[b])
        gt = gt_mels[b, :L]
        tf = tf_mels[b, :L]
        sums["mel_l1"] += mel_l1(tf, gt)
        all_frames = mcd_frames(tf, gt)
        sums["mcd"] += all_frames
        v = voiced_mask(gt)
        sums["mcd_voiced"] += (mcd_frames(tf[v], gt[v]) if v.any()
                               else all_frames)
        Lp = max(1, int(fr_lens[b]))
        sums["mcd_dtw"] += mcd_dtw(fr_mels[b, :Lp], gt)
    return sums
