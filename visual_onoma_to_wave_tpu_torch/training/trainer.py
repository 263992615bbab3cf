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
(`precision.pin_fp32`).

Under a process group of more than one (`parallel.init_distributed`), every
process plans the same global batches, loads only its rows of each
(`ProcessLoader.epoch(local_slice=)`, padded to the global batch's shapes)
and runs the data-parallel train step
(`train_state.py`): P processes take the one-process step on the global
batch. The batch size must divide by P. Parameters start equal (broadcast
from process 0); evaluate runs the whole val split on every process, so
every process holds the same numbers; only process 0 writes checkpoints,
logs and samples, and a barrier after each checkpoint keeps the others from
running ahead or leaving early. `train.compute_dtype: bfloat16` trains the
bf16 model of `VTTS.from_config` (bf16 FFT stacks and PostNet convs) with
fp32 parameters, Adam moments, BatchNorm statistics and losses, as the
reference's bf16 step does.

`profile_dir` writes a `torch.profiler` trace (CPU, and CUDA activity on the
card) of the steps after `profile_steps[0]` up to `profile_steps[1]` to
`<profile_dir>/trace_p<process>_steps<lo>-<hi>.json` (Chrome trace format),
closed at the end of training if the window is still open. The sample
synthesis draws the reference's mel + energy figure (`utils/plotting.py`:
the input strip, the target energy expanded by the target durations on both
panels, the character breaks, the energy axis pinned to the corpus's energy
min and max) to `<result>/Val/<step>_<name>.png` and to TensorBoard. Not
ported: the compile cache.
"""
from __future__ import annotations

import pathlib
from typing import Callable, Optional

import numpy as np
import torch

from visual_onoma_to_wave_tpu_torch.config import Config, DatasetMetadata
from visual_onoma_to_wave_tpu_torch.data.dataset import OnomaDataset, to_device
from visual_onoma_to_wave_tpu_torch.models.vtts import VTTS
from visual_onoma_to_wave_tpu_torch.parallel.distributed import (
    barrier,
    broadcast_module,
    is_primary,
    local_device,
    process_count,
    process_index,
)
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
from visual_onoma_to_wave_tpu_torch.utils.logging import MetricsLogger, NullLogger, StepTimer

LOSS_KEYS = ("total_loss", "mel_loss", "postnet_mel_loss", "energy_loss",
             "kurtosis_loss", "duration_loss")


class Trainer:
    def __init__(self, config: Config, restore_step: Optional[int] = None,
                 vocoder: Optional[torch.nn.Module] = None,
                 device: str | torch.device = "cuda",
                 loader_workers: Optional[int] = None,
                 profile_dir: Optional[str] = None, profile_steps: tuple[int, int] = (10, 15)):
        """vocoder: a generator module with its weights (`synthesis.load_vocoder`),
        for the waveform metrics of `evaluate` and the sample's audio.
        profile_dir: where the profiler trace of the steps in `profile_steps` goes."""
        world = process_count()
        self.device = resolve_device(local_device(device) if world > 1 else device)
        if config.train.optimizer.batch_size % world:
            raise ValueError(f"batch_size {config.train.optimizer.batch_size} does not divide "
                             f"by the {world} processes")
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
        broadcast_module(model)
        generator = torch.Generator(device=self.device).manual_seed(config.train.seed + 1)
        self.state = TrainState(model, optimizer, generator,
                                shard=(process_index(), world) if world > 1 else None)

        self.ckpt = CheckpointManager(config.path.ckpt)
        # the vocabulary beside the checkpoints: a checkpoint directory is
        # then self-describing for serving
        from visual_onoma_to_wave_tpu_torch.data.symbols import save_symbol_map
        if is_primary():
            save_symbol_map(self.ckpt.dir, self.train_ds.symbol_map)
        if restore_step == -1:      # -1 = the latest available
            restore_step = self.ckpt.latest_step()
        if restore_step is not None:
            self.ckpt.restore(self.state, restore_step)
        log = MetricsLogger if is_primary() else lambda *a: NullLogger()
        self.train_log, self.val_log = log(config.path.log, "train"), log(config.path.log, "val")
        self.result_dir = pathlib.Path(config.path.result)
        (self.result_dir / "Val").mkdir(parents=True, exist_ok=True)
        self.vocoder = vocoder.to(self.device).eval() if vocoder is not None else None
        self.timer = StepTimer()
        self.profile_dir = profile_dir
        self.profile_steps = tuple(profile_steps)
        self.profile_trace: Optional[pathlib.Path] = None    # the trace written last
        self._profiler = None

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
            self._save()
            return self.state
        from visual_onoma_to_wave_tpu_torch.data.loader import ProcessLoader
        loader = ProcessLoader(self.train_ds, "train.txt", num_workers=self.loader_workers)
        if is_primary():
            print(f"training: {self.n_params() / 1e6:.2f}M params, {len(self.train_ds)} clips, "
                  f"target {total} steps, {self.device}, loader backend {loader.backend}"
                  + (f" x{loader.num_workers}" if loader.backend == "process" else "")
                  + (f", {process_count()} processes" if self.state.shard else ""))
        try:
            self._train_loop(loader, total, step, cfg, on_step)
        finally:
            loader.close()
            self._stop_profile()
        self._save()
        return self.state

    def _save(self) -> None:
        """A checkpoint of the state, written by process 0 while the others
        wait."""
        if is_primary():
            self.ckpt.save(self.state)
        barrier("checkpoint")

    def _train_loop(self, loader, total, step, cfg, on_step) -> None:
        # every process plans the epoch from the shared seed and loads only
        # its rows of each batch (pad shapes from the plan's metadata)
        world = process_count()
        local_slice = (process_index(), world) if world > 1 else None
        epoch = 0
        while step < total:
            epoch += 1
            for batch in loader.epoch(group_size=4, seed=self.config.train.seed + epoch,
                                      local_slice=local_slice):
                jb = to_device(batch, self.device)
                self._maybe_profile(step)
                self.timer.start()
                losses = train_step(self.state, jb)
                step = self.state.step
                # the local rows' frames, scaled to the global batch (approximate)
                n_frames = int(np.sum(batch["mel_lens"])) * world
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
                if step % cfg.step.synth_step == 0 and is_primary():
                    self._synth_sample(step)
                if step % cfg.step.save_step == 0:
                    self._save()
                if on_step is not None:
                    on_step(step, losses)
                if step >= total:
                    break

    def _maybe_profile(self, step: int) -> None:
        """Start the trace before the step after `profile_steps[0]`; stop it
        once `profile_steps[1]` steps are done."""
        if self.profile_dir is None:
            return
        lo, hi = self.profile_steps
        if self._profiler is None and step == lo:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts, record_shapes=False)
            self._profiler.start()
            self._profile_from = step
        elif self._profiler is not None and step >= hi:
            self._stop_profile()

    def _stop_profile(self) -> None:
        """Close the trace (if one is open) and write it under `profile_dir`."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        out = pathlib.Path(self.profile_dir)
        out.mkdir(parents=True, exist_ok=True)
        path = out / (f"trace_p{process_index()}_steps{self._profile_from}-"
                      f"{self.state.step}.json")
        self._profiler.export_chrome_trace(str(path))
        self._profiler = None
        self.profile_trace = path
        self.train_log.text(f"profiler trace written to {path}")

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
        the mel + energy figure of both to `<result>/Val/<step>_<name>.png`
        (and TensorBoard), and with a vocoder the synthesized and
        reconstructed waveforms as wavs and TensorBoard audio (reference
        utils/tools.py:180-241)."""
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
        fig = self.sample_figure(step, batch, mels["synthesis"], mels["reconstruction"])
        fig.save(val_dir / f"{step}_{name}.png")
        self.train_log.image(step, "Synth/mel", np.asarray(fig))
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

    def sample_figure(self, step: int, batch: dict, mel_pred: np.ndarray,
                      mel_gt: np.ndarray):
        """The reference's mel + energy figure of one sample (the JAX
        trainer's `_synth_sample`): the target energy expanded by the target
        durations on both panels, the character breaks, the energy axis at
        the corpus's energy min and max, the rendered input strip on top."""
        from visual_onoma_to_wave_tpu_torch.utils.plotting import expand_char_values, plot_mel

        n_src = int(batch["src_lens"][0])
        energies = char_breaks = energy_ylim = None
        if "energies" in batch:
            dur = np.asarray(batch["durations"][0][:n_src])
            e = expand_char_values(np.asarray(batch["energies"][0][:n_src]), dur)
            energies = [e[:mel_pred.shape[0]], e[:mel_gt.shape[0]]]
            char_breaks = [np.insert(np.cumsum(dur), 0, 0)] * 2
            es = self.metadata.energy_stats
            energy_ylim = (es.min, es.max)
        strip = None
        if "image_cells" in batch:
            cells = np.asarray(batch["image_cells"][0][:n_src])           # (C, H, W)
            strip = (cells.transpose(1, 0, 2).reshape(cells.shape[1], -1) * 255).astype(np.uint8)
        return plot_mel([(mel_pred, f"synthesized (step {step})"), (mel_gt, "ground truth")],
                        energies=energies, char_breaks=char_breaks, energy_ylim=energy_ylim,
                        input_image=strip)
