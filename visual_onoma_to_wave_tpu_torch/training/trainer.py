"""Training orchestrator, the `04_train.py` equivalent (port of
visual_onoma_to_wave_tpu/training/trainer.py, one device).

Reproduces the reference loop (reference scripts/04_train.py:115-175):
  * periodic scalar logging (log_step), validation (val_step, with the
    quality metrics when `train.step.val_metrics`), sample synthesis
    (synth_step), checkpointing (save_step), stop at total_step;
  * length-weighted validation losses over the full val split
    (reference scripts/evaluate.py:17-105);
  * resume from a checkpoint restores the model, the optimizer (Adam's
    moments and the schedule's count), the mini-step count and the dropout
    generator; the batches start again from epoch 1's plan, as the
    reference's do.

Epoch e's batches are planned with seed `train.seed + e` and dropout draws
from one `torch.Generator` seeded `train.seed + 1`, as the reference does.
The train step runs no hand-written kernel (the attention kernel has no
backward); evaluate and sample synthesis run the model in `.eval()`, where
it does. On the card, TF32 is turned off before the first step
(`precision.pin_fp32`). Not ported: the device mesh and multi-host data
parallelism (ROADMAP A5), the compile cache, the profiler trace, and the
sample's figure (matplotlib); `train.compute_dtype: bfloat16` raises.
"""
from __future__ import annotations

import pathlib
from typing import Callable, Optional

import numpy as np
import torch

from visual_onoma_to_wave_tpu_torch.config import Config, DatasetMetadata
from visual_onoma_to_wave_tpu_torch.data.dataset import OnomaDataset, to_device
from visual_onoma_to_wave_tpu_torch.models.vtts import VTTS
from visual_onoma_to_wave_tpu_torch.synthesis import resolve_device, vocode
from visual_onoma_to_wave_tpu_torch.training.schedule import NoamAdam
from visual_onoma_to_wave_tpu_torch.training.train_state import (
    MODEL_INPUTS,
    TrainState,
    eval_step,
    synth_step,
    train_step,
)
from visual_onoma_to_wave_tpu_torch.utils.checkpoint import CheckpointManager
from visual_onoma_to_wave_tpu_torch.utils.logging import MetricsLogger, StepTimer

LOSS_KEYS = ("total_loss", "mel_loss", "postnet_mel_loss", "energy_loss",
             "kurtosis_loss", "duration_loss")


class Trainer:
    def __init__(self, config: Config, restore_step: Optional[int] = None,
                 vocoder: Optional[torch.nn.Module] = None,
                 device: str | torch.device = "cuda",
                 loader_workers: Optional[int] = None):
        """vocoder: a generator module with its weights (`synthesis.load_vocoder`),
        for the waveform metrics of `evaluate` and the sample's audio."""
        if config.train.compute_dtype not in ("float32", "fp32"):
            raise NotImplementedError(
                f"compute_dtype {config.train.compute_dtype!r}: the port trains float32 "
                "only so far (ROADMAP A6, bf16 compute)")
        self.device = resolve_device(device)
        self.config = config
        self.loader_workers = loader_workers
        self.metadata = DatasetMetadata.load(config.path.preprocessed)
        self.train_ds = OnomaDataset("train.txt", config, sort=True, drop_last=True,
                                     metadata=self.metadata)
        self.val_ds = OnomaDataset("val.txt", config, sort=False, drop_last=False,
                                   metadata=self.metadata)
        torch.manual_seed(config.train.seed)
        model = VTTS.from_config(config, self.metadata,
                                 n_vocab=self.train_ds.n_vocab).to(self.device)
        opt = config.train.optimizer
        optimizer = NoamAdam(
            model.parameters(), init_lr=opt.init_lr, warmup_steps=opt.warm_up_step,
            anneal_steps=opt.anneal_steps, anneal_rate=opt.anneal_rate, betas=opt.betas,
            eps=opt.eps, weight_decay=opt.weight_decay, grad_clip=opt.grad_clip_thresh,
            grad_acc_steps=opt.grad_acc_step)
        generator = torch.Generator(device=self.device).manual_seed(config.train.seed + 1)
        self.state = TrainState(model, optimizer, generator)

        self.ckpt = CheckpointManager(config.path.ckpt)
        # the vocabulary beside the checkpoints: a checkpoint directory is
        # then self-describing for serving
        from visual_onoma_to_wave_tpu_torch.data.symbols import save_symbol_map
        save_symbol_map(self.ckpt.dir, self.train_ds.symbol_map)
        if restore_step == -1:      # -1 = the latest available
            restore_step = self.ckpt.latest_step()
        if restore_step is not None:
            self.ckpt.restore(self.state, restore_step)
        self.train_log = MetricsLogger(config.path.log, "train")
        self.val_log = MetricsLogger(config.path.log, "val")
        self.result_dir = pathlib.Path(config.path.result)
        (self.result_dir / "Val").mkdir(parents=True, exist_ok=True)
        self.vocoder = vocoder.to(self.device).eval() if vocoder is not None else None
        self.timer = StepTimer()

    def n_params(self) -> int:
        return sum(p.numel() for p in self.state.model.parameters())

    # ------------------------------------------------------------------
    def train(self, max_steps: Optional[int] = None,
              on_step: Optional[Callable] = None) -> TrainState:
        """Train to `max_steps` (default `train.step.total_step`). After each
        step, once its logging, validation and checkpoint are done,
        `on_step(step, losses)` is called with the step's losses (tensors;
        floats on a log step)."""
        cfg = self.config.train
        total = max_steps if max_steps is not None else cfg.step.total_step
        step = self.state.step
        if step >= total:
            print(f"training: already at step {step} >= {total}, nothing to do")
            self.ckpt.save(self.state)
            return self.state
        from visual_onoma_to_wave_tpu_torch.data.loader import ProcessLoader
        loader = ProcessLoader(self.train_ds, "train.txt", num_workers=self.loader_workers)
        print(f"training: {self.n_params() / 1e6:.2f}M params, {len(self.train_ds)} clips, "
              f"target {total} steps, {self.device}, loader backend {loader.backend}"
              + (f" x{loader.num_workers}" if loader.backend == "process" else ""))
        try:
            self._train_loop(loader, total, step, cfg, on_step)
        finally:
            loader.close()
        self.ckpt.save(self.state)
        return self.state

    def _train_loop(self, loader, total, step, cfg, on_step) -> None:
        epoch = 0
        while step < total:
            epoch += 1
            for batch in loader.epoch(group_size=4, seed=self.config.train.seed + epoch):
                jb = to_device(batch, self.device)
                self.timer.start()
                losses = train_step(self.state, jb)
                step = self.state.step
                n_frames = int(np.sum(batch["mel_lens"]))
                if step % cfg.step.log_step == 0:
                    losses = {k: float(v) for k, v in losses.items()}
                    self.timer.stop(n_frames)
                    losses["frames_per_sec"] = self.timer.frames_per_sec
                    self.train_log.scalars(step, losses)
                    self.train_log.text(
                        f"step {step} epoch {epoch} total {losses['total_loss']:.4f} "
                        f"mel {losses['mel_loss']:.4f} fps {losses['frames_per_sec']:.0f}")
                else:
                    self.timer.stop(n_frames)
                if step % cfg.step.val_step == 0:
                    self.val_log.scalars(step, self.evaluate(step, metrics=cfg.step.val_metrics))
                if step % cfg.step.synth_step == 0:
                    self._synth_sample(step)
                if step % cfg.step.save_step == 0:
                    self.ckpt.save(self.state)
                if on_step is not None:
                    on_step(step, losses)
                if step >= total:
                    break

    # ------------------------------------------------------------------
    def evaluate(self, step: int | None = None, metrics: bool = False) -> dict:
        """Length-weighted mean losses over the full val split.

        metrics=True adds teacher-forced mel_l1, mcd and mcd_voiced and the
        free-running mcd_dtw (dB; `metrics.py`). With a vocoder and a corpus
        preprocessed with --save-audio it also reports the waveform-domain
        multi-resolution STFT distance (mrstft_sc / _mag) of the vocoded
        teacher-forced mel against the ground-truth audio."""
        model = self.state.model
        sums = {k: 0.0 for k in LOSS_KEYS}
        wave_gt: dict[str, pathlib.Path] = {}
        if metrics:
            from visual_onoma_to_wave_tpu_torch.metrics import batch_quality_metrics
            sums.update({"mel_l1": 0.0, "mcd": 0.0, "mcd_voiced": 0.0, "mcd_dtw": 0.0})
            audio_root = pathlib.Path(self.config.path.preprocessed) / "audio"
            if self.vocoder is not None and audio_root.is_dir():
                wave_gt = {p.stem: p for p in audio_root.glob("*/*.npy")}
        if wave_gt:
            from visual_onoma_to_wave_tpu_torch.metrics import mrstft_distance
            hop = self.config.audio.stft.hop_length
            sums.update({"mrstft_sc": 0.0, "mrstft_mag": 0.0})
            n_wave = 0
        n = 0
        for batch in self.val_ds.batches(group_size=1, shuffle=False):
            jb = to_device(batch, self.device)
            losses, outputs = eval_step(model, jb)
            bs = batch["texts"].shape[0]
            for k in LOSS_KEYS:
                sums[k] += float(losses[k]) * bs
            if metrics:
                fr = synth_step(model, {k: jb[k] for k in MODEL_INPUTS if k in jb})
                tf_mel = outputs["postnet_mel"].cpu().numpy()
                q = batch_quality_metrics(tf_mel, fr["postnet_mel"].cpu().numpy(),
                                          fr["mel_lens"].cpu().numpy(), batch["mels"],
                                          batch["mel_lens"])
                for k, v in q.items():
                    sums[k] += v
                if wave_gt:
                    mel_lens = batch["mel_lens"]
                    # batch-pad frames to the mel silence floor before
                    # vocoding: the PostNet output there is arbitrary, and
                    # the generator's receptive field would carry it into
                    # the scored tail of every item but the longest, making
                    # the metric depend on how the batch was composed
                    tf = tf_mel.copy()
                    tf[np.arange(tf.shape[1])[None, :] >= mel_lens[:, None]] = float(np.log(1e-5))
                    with torch.no_grad():
                        wavs = vocode(self.vocoder, torch.from_numpy(tf).to(self.device))
                    wavs = wavs.cpu().numpy()
                    for b, name in enumerate(batch["names"]):
                        p = wave_gt.get(name)
                        if p is None:
                            continue
                        pred = np.clip(wavs[b, : int(mel_lens[b]) * hop], -1.0, 1.0)
                        d = mrstft_distance(pred, np.load(p))
                        sums["mrstft_sc"] += d["sc"]
                        sums["mrstft_mag"] += d["mag"]
                        n_wave += 1
            n += bs
        means = {k: (v / n if n else float("nan")) for k, v in sums.items()}
        if wave_gt:
            for k in ("mrstft_sc", "mrstft_mag"):
                means[k] = sums[k] / n_wave if n_wave else float("nan")
        if step is not None:
            self.val_log.text(f"validation step {step}: total {means['total_loss']:.4f}")
        return means

    # ------------------------------------------------------------------
    def _synth_sample(self, step: int) -> None:
        """Synthesize one val sample (predicted durations): its mel to
        `<result>/Val/<step>_<name>_synthesis.npy` beside the ground truth's,
        and with a vocoder the synthesized and reconstructed waveforms as
        wavs and TensorBoard audio (reference utils/tools.py:180-241; the
        reference's figure is not drawn)."""
        try:
            batch = next(self.val_ds.batches(group_size=1, shuffle=True, seed=step))
        except StopIteration:
            return
        jb = to_device(batch, self.device)
        out = synth_step(self.state.model, {k: jb[k] for k in MODEL_INPUTS if k in jb})
        mel_len = max(int(out["mel_lens"][0]), 1)
        gt_len = int(batch["mel_lens"][0])
        name = batch["names"][0]
        mels = {"synthesis": out["postnet_mel"][0, :mel_len].cpu().numpy(),
                "reconstruction": batch["mels"][0][:gt_len]}
        val_dir = self.result_dir / "Val"
        np.save(val_dir / f"{step}_{name}_synthesis.npy", mels["synthesis"])
        np.save(val_dir / f"{step}_{name}_ground_truth.npy", mels["reconstruction"])
        if self.vocoder is None:
            return
        from visual_onoma_to_wave_tpu_torch.data.audio_io import write_wav
        sr = self.config.audio.sampling_rate
        for tag, m in mels.items():
            with torch.no_grad():
                wav = vocode(self.vocoder, torch.from_numpy(np.ascontiguousarray(m))[None]
                             .to(self.device))[0].cpu().numpy()
            self.train_log.audio(step, f"Synth/{tag}", wav, sr)
            write_wav(val_dir / f"{step}_{name}_{tag}.wav", np.clip(wav, -1, 1), sr)
