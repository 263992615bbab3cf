"""Training observability: TensorBoard + jsonl + plain-text logging
(copy of visual_onoma_to_wave_tpu/utils/logging.py).

Mirrors the reference's dual TensorBoard writers + log.txt appends
(reference scripts/04_train.py:20-36,143-150; utils/tools.py:140-162) and adds
a machine-readable metrics.jsonl stream (step time, frames/sec) that the
reference lacks (SURVEY.md §5 tracing: none).
"""
from __future__ import annotations

import json
import pathlib
import time
from typing import Any

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str | pathlib.Path, name: str = "train",
                 use_tensorboard: bool = True):
        self.dir = pathlib.Path(log_dir) / name
        self.dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.dir / "metrics.jsonl", "a")
        self._txt = open(self.dir / "log.txt", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(str(self.dir))
            except Exception:
                self._tb = None

    def scalars(self, step: int, values: dict[str, Any], prefix: str = "Loss") -> None:
        clean = {k: float(v) for k, v in values.items()
                 if np.isscalar(v) or getattr(v, "ndim", 1) == 0}
        self._jsonl.write(json.dumps({"step": step, "time": time.time(), **clean}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(f"{prefix}/{k}", v, step)

    def text(self, message: str) -> None:
        self._txt.write(message + "\n")
        self._txt.flush()

    def audio(self, step: int, tag: str, wav: np.ndarray, sample_rate: int = 22050) -> None:
        if self._tb is not None:
            peak = max(float(np.abs(wav).max()), 1e-8)
            self._tb.add_audio(tag, wav / peak, step, sample_rate=sample_rate)

    def figure(self, step: int, tag: str, fig) -> None:
        if self._tb is not None:
            self._tb.add_figure(tag, fig, step)

    def image(self, step: int, tag: str, img: np.ndarray) -> None:
        """An (H, W, 3) uint8 image (the port draws its figures with PIL)."""
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")

    def close(self) -> None:
        self._jsonl.close()
        self._txt.close()
        if self._tb is not None:
            self._tb.close()


class NullLogger:
    """MetricsLogger-shaped no-op: non-primary processes of a multi-host
    run log nothing (the primary owns log/ckpt side effects —
    parallel/distributed.py is_primary)."""

    def scalars(self, step, values, prefix="Loss") -> None:
        pass

    def text(self, message) -> None:
        pass

    def audio(self, step, tag, wav, sample_rate=22050) -> None:
        pass

    def figure(self, step, tag, fig) -> None:
        pass

    def image(self, step, tag, img) -> None:
        pass

    def close(self) -> None:
        pass


class StepTimer:
    """Rolling step-time / throughput tracker (frames/sec per device)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self.frames: list[int] = []
        self._last = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def stop(self, n_frames: int) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            self.frames.append(n_frames)
            if len(self.times) > self.window:
                self.times.pop(0)
                self.frames.pop(0)
        self._last = None

    @property
    def step_time(self) -> float:
        return float(np.mean(self.times)) if self.times else float("nan")

    @property
    def frames_per_sec(self) -> float:
        if not self.times:
            return float("nan")
        return float(np.sum(self.frames) / np.sum(self.times))
