"""GAN training of a vocoder generator against MPD + MSD (or MRD)
discriminators (port of visual_onoma_to_wave_tpu/training/vocoder_trainer.py).

One step is the official HiFi-GAN update order, as the reference's:

  * one generator forward (the generator in `.train()`, so every MRF stage
    and ConvNeXt block takes its plain version with autograd: no
    hand-written kernel runs inside a step, as no Pallas kernel runs inside
    the reference's);
  * the discriminator update on the detached waveform;
  * the generator loss (adversarial + feature matching + 45 x mel L1, the
    log-mel of `ops/stft.logmel_and_energy`, its first segment / hop
    frames) against the *updated* discriminators, backpropagated through
    the same forward; the discriminators' parameters are frozen for it.

Both optimizers are optax's `adamw(exponential_decay(lr, 1000, 0.999,
staircase), b1 0.8, b2 0.99, weight_decay 0.01)`, each preceded by optax's
`clip_by_global_norm` over its whole tree when `grad_clip_norm > 0`
(`OptaxAdamW`): one for the generator, one for MPD and MSD together. The
generator's exponential moving average runs when `ema_decay > 0`. The
divergence watchdog, the halt marker and the last-healthy snapshot are the
reference's.

Checkpoints are `.npz` files: `<ckpt>/<step>/generator.npz` (and
`generator_ema.npz`) in the flax layout (`bridge.vocoder_tree`), which
`synthesis.load_vocoder` and `cli synthesize --vocoder` read as they are;
`full_state.npz` (every parameter, both optimizers' moments and counts, the
EMA and the step) and `sampler_state.json` for an exact resume.

Under a process group of more than one (`parallel.init_distributed`) the
trainer is data-parallel: every process draws the same global batch from
its sampler and keeps its rows; every loss is a plain mean over equal
shares, so averaging both updates' gradients over the processes (before
the clip) gives the one-process step on the global batch. Both optimizers
and the EMA then move alike everywhere, the losses each step returns are
averaged too, so the watchdog decides alike, and only process 0 writes
checkpoints while a barrier holds the others.

`compute_dtype="bfloat16"` is the reference's mixed-precision GAN step: the
default generator and discriminators are built in bf16 (their convs compute
in bf16, `precision.at_dtype`), while the parameters, both optimizers'
state, the EMA, every loss and the mel DSP stay fp32 (the generator's
waveform and the discriminators' logits leave their modules in fp32). Not
ported here: JAX's device mesh (`use_mesh`), whose role one process per
device takes; the compile cache.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import shutil
import time
from typing import Sequence

import numpy as np
import torch
from torch import nn

from visual_onoma_to_wave_tpu_torch.bridge import save_npz, vocoder_tree
from visual_onoma_to_wave_tpu_torch.models.bigvgan import BigVGANGenerator
from visual_onoma_to_wave_tpu_torch.models.hifigan import HiFiGANGenerator
from visual_onoma_to_wave_tpu_torch.models.hifigan_disc import (
    MultiPeriodDiscriminator,
    MultiScaleDiscriminator,
    WNConv,
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
)
from visual_onoma_to_wave_tpu_torch.models.istftnet import ISTFTNetGenerator
from visual_onoma_to_wave_tpu_torch.models.vocos import VocosGenerator
from visual_onoma_to_wave_tpu_torch.ops.stft import hann_window, logmel_and_energy, melscale_fbanks
from visual_onoma_to_wave_tpu_torch.parallel.distributed import (
    all_reduce_grads,
    all_reduce_tensors,
    barrier,
    broadcast_module,
    is_primary,
    local_device,
    process_count,
    shard_batch_multiprocess,
)
from visual_onoma_to_wave_tpu_torch.precision import compute_dtype
from visual_onoma_to_wave_tpu_torch.synthesis import resolve_device
from visual_onoma_to_wave_tpu_torch.training.schedule import global_norm


@dataclasses.dataclass(frozen=True)
class VocoderTrainConfig:
    """Training hyper-parameters (defaults: the HiFi-GAN V1 recipe); the
    reference's fields, meanings and defaults."""

    segment_size: int = 8192          # samples per training segment
    batch_size: int = 16
    learning_rate: float = 2e-4
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    lr_decay: float = 0.999           # per lr_decay_steps
    lr_decay_steps: int = 1000
    mel_loss_weight: float = 45.0
    total_steps: int = 200_000
    log_every: int = 100
    save_every: int = 10_000
    seed: int = 0
    # audio / DSP (the acoustic model's domain)
    sampling_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float = 8000.0
    compute_dtype: str = "float32"    # "bfloat16": the mixed-precision GAN step
    ema_decay: float = 0.0            # 0 = off (the official recipe)
    grad_clip_norm: float = 0.0       # global-norm clip of both updates; 0 = off
    # the divergence watchdog (`VocoderTrainer._check_divergence`)
    divergence_factor: float = 4.0
    divergence_patience: int = 5
    on_divergence: str = "halt"       # "halt" | "warn"
    divergence_mel_ceiling: float = 1.5
    divergence_warmup_windows: int = 10
    frozen_patience: int = 3
    healthy_snapshot_windows: int = 20


def family_recipe(family: str) -> dict:
    """The default recipe of a generator family: {"learning_rate",
    "grad_clip_norm", "disc"}. BigVGAN: lr 1e-4, clip 1e3, MPD + MRD;
    iSTFTNet: lr 1e-4, clip 1e3, MPD + MSD (both collapse under the flat
    recipe in the reference's 20k arms); every other family the flat
    HiFi-GAN recipe, lr 2e-4, no clip, MPD + MSD."""
    f = family.lower().replace("-", "").replace("_", "")
    if f.startswith("bigvgan"):
        return {"learning_rate": 1e-4, "grad_clip_norm": 1e3, "disc": "mrd"}
    if f.startswith("istftnet"):
        return {"learning_rate": 1e-4, "grad_clip_norm": 1e3, "disc": "msd"}
    return {"learning_rate": 2e-4, "grad_clip_norm": 0.0, "disc": "msd"}


class SegmentSampler:
    """Random fixed-size audio segments from a list of clips (host side);
    clips shorter than segment_size are zero-padded. The stream is numpy's
    `default_rng(cfg.seed)`, draw for draw the reference's."""

    def __init__(self, clips: Sequence[np.ndarray], cfg: VocoderTrainConfig):
        if not clips:
            raise ValueError("no training clips")
        self.clips = [np.asarray(c, np.float32).reshape(-1) for c in clips]
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)

    def next_batch(self) -> np.ndarray:
        s = self.cfg.segment_size
        out = np.zeros((self.cfg.batch_size, s), np.float32)
        idx = self.rng.integers(0, len(self.clips), self.cfg.batch_size)
        for i, ci in enumerate(idx):
            clip = self.clips[ci]
            if len(clip) > s:
                start = int(self.rng.integers(0, len(clip) - s + 1))
                out[i] = clip[start:start + s]
            else:
                out[i, :len(clip)] = clip
        return out


class PairedSegmentSampler:
    """Aligned (audio, mel) segments for fine-tuning: pairs of (audio (S,),
    mel (T, n_mels)) with mel frame t covering samples [t*hop, (t+1)*hop),
    cut on frame boundaries. `next_batch` -> (audio (B, segment), mel (B,
    n_mels, segment / hop)), the mel's missing frames at ln(1e-5)."""

    def __init__(self, pairs, cfg: VocoderTrainConfig):
        if not pairs:
            raise ValueError("no training pairs")
        if cfg.segment_size % cfg.hop_length:
            raise ValueError("segment_size must be a hop multiple")
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.pairs = []
        self.t_seg = cfg.segment_size // cfg.hop_length
        for audio, mel in pairs:
            audio = np.asarray(audio, np.float32).reshape(-1)
            mel = np.asarray(mel, np.float32)
            t = min(len(audio) // cfg.hop_length, mel.shape[0])
            if t < 1:
                continue
            self.pairs.append((audio[:t * cfg.hop_length], mel[:t]))
        if not self.pairs:
            raise ValueError("all pairs shorter than one hop")

    def next_batch(self):
        c = self.cfg
        audio = np.zeros((c.batch_size, c.segment_size), np.float32)
        mel = np.full((c.batch_size, self.t_seg, c.n_mels), float(np.log(1e-5)), np.float32)
        idx = self.rng.integers(0, len(self.pairs), c.batch_size)
        for i, pi in enumerate(idx):
            a, m = self.pairs[pi]
            t = m.shape[0]
            if t > self.t_seg:
                f0 = int(self.rng.integers(0, t - self.t_seg + 1))
                mel[i] = m[f0:f0 + self.t_seg]
                audio[i] = a[f0 * c.hop_length:f0 * c.hop_length + c.segment_size]
            else:
                mel[i, :t] = m
                audio[i, :t * c.hop_length] = a
        return audio, mel.transpose(0, 2, 1)


@torch.no_grad()
def teacher_forced_pairs(trainer, limit: int | None = None):
    """(audio, predicted mel (T, n_mels)) fine-tuning pairs from the port's
    acoustic `Trainer`: its model in `.eval()` (the attention kernel on the
    card) with ground-truth durations over the train split, one clip a
    batch, each postnet mel paired with the preprocessor's saved waveform
    `audio/<label>/<name>.npy` (`Preprocessor(save_audio=True)`); rows
    without saved audio are skipped."""
    from visual_onoma_to_wave_tpu_torch.data.dataset import to_device
    from visual_onoma_to_wave_tpu_torch.training.train_state import eval_step

    root = pathlib.Path(trainer.config.path.preprocessed)
    labels = {name: label for name, label, *_ in trainer.train_ds.rows}
    pairs = []
    for batch in trainer.train_ds.batches(group_size=1, shuffle=False):
        _, outputs = eval_step(trainer.state.model, to_device(batch, trainer.device))
        mels = outputs["postnet_mel"].float().cpu().numpy()
        lens = outputs["mel_lens"].cpu().numpy()
        for i, name in enumerate(batch["names"]):
            p = root / "audio" / labels[name] / f"{name}.npy"
            if not p.exists():
                continue
            pairs.append((np.load(p), mels[i, :int(lens[i])]))
            if limit and len(pairs) >= limit:
                return pairs
    return pairs


def load_wav_dir(wav_dir: str | pathlib.Path, limit: int | None = None,
                 target_sr: int = 22050):
    """Every .wav under `wav_dir` (sorted, recursively) as float32 in
    [-1, 1] at `target_sr` (the port's `data/audio_io.load_audio`)."""
    from visual_onoma_to_wave_tpu_torch.data.audio_io import load_audio

    paths = sorted(pathlib.Path(wav_dir).rglob("*.wav"))
    if limit:
        paths = paths[:limit]
    return [load_audio(p, target_sr) for p in paths]


class OptaxAdamW:
    """optax `chain(clip_by_global_norm(clip), adamw(exponential_decay(lr,
    decay_steps, decay_rate, staircase=True), b1, b2, weight_decay))` over
    the `.grad` of `params`: the global norm of all of them, g / norm * clip
    when norm >= clip (optax's rule, not torch's clip_grad_norm_); then
    AdamW at the rate the schedule gives the count of updates applied
    before this one."""

    def __init__(self, params, lr: float, b1: float, b2: float, decay_steps: int,
                 decay_rate: float, clip: float = 0.0, weight_decay: float = 0.01):
        self.params = list(params)
        self.lr, self.decay_steps, self.decay_rate = lr, decay_steps, decay_rate
        self.clip = clip
        self.adam = torch.optim.AdamW(self.params, lr=lr, betas=(b1, b2), eps=1e-8,
                                      weight_decay=weight_decay)
        self.count = 0

    def lr_at(self, count: int) -> float:
        return self.lr * self.decay_rate ** (count // self.decay_steps)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @staticmethod
    @torch.no_grad()
    def clip_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
        """optax's `clip_by_global_norm` in place: g / norm * max_norm when the
        global norm >= max_norm (no host sync). Returns the norm."""
        norm = global_norm(grads)
        clipped = norm >= max_norm
        torch._foreach_div_(grads, torch.where(clipped, norm, 1.0))
        torch._foreach_mul_(grads, torch.where(clipped, max_norm, 1.0).to(norm))
        return norm

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip > 0.0:
            self.clip_([p.grad for p in self.params], self.clip)
        for group in self.adam.param_groups:
            group["lr"] = self.lr_at(self.count)
        self.adam.step()
        self.count += 1

    def state_arrays(self, prefix: str) -> dict[str, torch.Tensor]:
        out = {f"{prefix}/count": torch.tensor(self.count)}
        for i, p in enumerate(self.params):
            st = self.adam.state.get(p)
            if st:
                for k in ("exp_avg", "exp_avg_sq", "step"):
                    out[f"{prefix}/{i}/{k}"] = st[k].detach().cpu()
        return out

    def load_state_arrays(self, prefix: str, arrays: dict[str, torch.Tensor]) -> None:
        self.count = int(arrays[f"{prefix}/count"])
        self.adam.state.clear()
        for i, p in enumerate(self.params):
            if f"{prefix}/{i}/step" in arrays:
                self.adam.state[p] = {
                    k: arrays[f"{prefix}/{i}/{k}"].to(p.device if k != "step" else "cpu").clone()
                    for k in ("exp_avg", "exp_avg_sq", "step")}


def generator_family(gen: nn.Module) -> str:
    """The `bridge.vocoder_tree` family of a trainable generator module."""
    if isinstance(gen, (HiFiGANGenerator, ISTFTNetGenerator)):
        return "hifigan"
    if isinstance(gen, VocosGenerator):
        return "vocos"
    if isinstance(gen, BigVGANGenerator):
        return "bigvgan"
    raise ValueError(f"{type(gen).__name__} is not a trainable generator (HiFi-GAN, "
                     "iSTFTNet, Vocos or BigVGAN)")


@torch.no_grad()
def init_like_reference_(module: nn.Module) -> None:
    """The reference's initial distributions, drawn from torch's global RNG:
    HiFi-GAN, iSTFTNet and BigVGAN weights N(0, 0.01) with biases and snake
    parameters 0; Vocos weights N(0, 0.02) cut at two standard deviations,
    biases 0, norm scales 1 (gamma keeps its constant); every `WNConv` of a
    discriminator v as torch's conv default, g sqrt(1/3), b 0."""
    if isinstance(module, VocosGenerator):
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("_w"):
                nn.init.trunc_normal_(p, std=0.02, a=-0.04, b=0.04)
            elif leaf.endswith("_scale"):
                nn.init.ones_(p)
            elif leaf != "gamma":
                nn.init.zeros_(p)
    elif isinstance(module, (HiFiGANGenerator, ISTFTNetGenerator, BigVGANGenerator)):
        for name, p in module.named_parameters():
            if name.endswith(".weight"):
                nn.init.normal_(p, std=0.01)
            else:
                nn.init.zeros_(p)
    else:
        for m in module.modules():
            if isinstance(m, WNConv):
                nn.init.kaiming_uniform_(m.v, a=math.sqrt(5))
                nn.init.constant_(m.g, float(np.sqrt(1 / 3)))
                nn.init.zeros_(m.b)


@dataclasses.dataclass
class GANTrainState:
    step: int
    gen: nn.Module
    mpd: nn.Module
    msd: nn.Module
    gen_opt: OptaxAdamW
    disc_opt: OptaxAdamW
    gen_ema: list[torch.Tensor] | None = None   # the generator's parameters' EMA


class VocoderTrainer:
    """Drives GAN training of a vocoder generator (HiFi-GAN V1 by default;
    any HiFi-GAN, iSTFTNet, Vocos or BigVGAN generator whose upsampling
    equals hop_length). `clips`: float32 waveforms in [-1, 1] at
    cfg.sampling_rate; `pairs`: (audio, mel) pairs for fine-tuning instead.
    `msd` takes any module of the MSD's (y, y_hat) interface, such as
    `MultiResolutionDiscriminator()`. The generator and discriminators are
    initialised here from `cfg.seed` (the reference's distributions), then
    moved to `device` (CUDA unless "cpu" is asked for; under a process group
    of more than one, this process's card). `use_mesh=True` raises: data
    parallelism is over processes (module docstring)."""

    def __init__(self, clips: Sequence[np.ndarray] | None, cfg: VocoderTrainConfig | None = None,
                 gen: nn.Module | None = None, ckpt_dir: str | pathlib.Path | None = None,
                 log_dir: str | pathlib.Path | None = None,
                 mpd: nn.Module | None = None, msd: nn.Module | None = None,
                 pairs=None, device: str | torch.device = "cuda", use_mesh: bool = False):
        self.cfg = c = cfg or VocoderTrainConfig()
        if use_mesh:
            raise NotImplementedError(
                "use_mesh is JAX's device mesh: the port's data parallelism (ROADMAP A5) runs "
                "one process per device (parallel.init_distributed, then a VocoderTrainer in "
                "every process)")
        self.world = process_count()
        if c.batch_size % self.world:
            raise ValueError(f"batch_size {c.batch_size} does not divide by the {self.world} "
                             "processes")
        if not 0.0 <= c.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {c.ema_decay}")
        if c.on_divergence not in ("warn", "halt"):
            raise ValueError(f"on_divergence must be 'warn' or 'halt', got {c.on_divergence!r}")
        dtype = compute_dtype(c.compute_dtype)
        gen = gen if gen is not None else HiFiGANGenerator(dtype=dtype)
        self.family = generator_family(gen)
        up = int(getattr(gen, "total_upsample", 0) or np.prod(gen.upsample_rates))
        if up != c.hop_length:
            raise ValueError(f"generator upsampling {up} != hop_length {c.hop_length}")
        self.device = resolve_device(local_device(device) if self.world > 1 else device)
        mpd = mpd if mpd is not None else MultiPeriodDiscriminator(dtype=dtype)
        msd = msd if msd is not None else MultiScaleDiscriminator(dtype=dtype)
        torch.manual_seed(c.seed)
        for m in (gen, mpd, msd):
            init_like_reference_(m)
        gen, mpd, msd = (m.to(self.device).train() for m in (gen, mpd, msd))
        for m in (gen, mpd, msd):
            broadcast_module(m)
        self.gen, self.mpd, self.msd = gen, mpd, msd
        if pairs is not None:
            self.sampler = PairedSegmentSampler(pairs, c)
        else:
            self.sampler = SegmentSampler(clips, c)
        self.ckpt_dir = pathlib.Path(ckpt_dir) if ckpt_dir else None
        self.log = None
        if log_dir is not None and is_primary():
            from visual_onoma_to_wave_tpu_torch.utils.logging import MetricsLogger
            self.log = MetricsLogger(log_dir, name="vocoder")

        def adamw(params):
            return OptaxAdamW(params, c.learning_rate, c.adam_b1, c.adam_b2, c.lr_decay_steps,
                              c.lr_decay, c.grad_clip_norm)
        self.state = GANTrainState(
            step=0, gen=gen, mpd=mpd, msd=msd, gen_opt=adamw(gen.parameters()),
            disc_opt=adamw([*mpd.parameters(), *msd.parameters()]),
            gen_ema=([p.detach().clone() for p in gen.parameters()]
                     if c.ema_decay > 0.0 else None))

        self._window = torch.from_numpy(hann_window(c.win_length)).to(self.device)
        self._fb = torch.from_numpy(melscale_fbanks(c.n_fft // 2 + 1, c.f_min, c.f_max, c.n_mels,
                                                    c.sampling_rate)).to(self.device)
        # the divergence watchdog's state (`_check_divergence`)
        self.diverged_at: int | None = None
        self._best_mel_l1 = float("inf")
        self._bad_windows = 0
        self._windows_seen = 0
        self._last_mel: float | None = None
        self._frozen_windows = 0
        self._healthy_windows = 0
        # (step, generator state_dict, EMA tensors | None) on the host
        self._healthy_snapshot: tuple | None = None

    # ------------------------------------------------------------------ step
    def mel_of(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, S) -> (B, n_mels, S / hop): the log-mel of `logmel_and_energy`
        (centre framing gives S / hop + 1 frames; the first S / hop are
        kept, so that a segment's mel has the generator's input length)."""
        c = self.cfg
        logmel, _ = logmel_and_energy(audio, self._window, self._fb, c.n_fft, c.hop_length,
                                      c.win_length)
        return logmel[..., :c.segment_size // c.hop_length]

    def train_step(self, audio: torch.Tensor, mel: torch.Tensor | None = None) -> dict:
        """One GAN step on `audio` (B, segment_size); `mel` (B, n_mels,
        segment / hop), when given, is the generator's input in place of the
        audio's own log-mel (fine-tuning on predicted mels; the mel L1 target
        is always the audio's). Returns the losses as 0-d tensors."""
        st, c = self.state, self.cfg
        for m in (st.gen, st.mpd, st.msd):
            m.train()
        with torch.no_grad():
            mel_target = self.mel_of(audio)
        mel_in = mel_target if mel is None else mel
        y_hat = st.gen(mel_in.transpose(1, 2))

        y_sg = y_hat.detach()
        pr, pg, _, _ = st.mpd(audio, y_sg)
        sr, sg, _, _ = st.msd(audio, y_sg)
        d_mpd, d_msd = discriminator_loss(pr, pg), discriminator_loss(sr, sg)
        d_total = d_mpd + d_msd
        st.disc_opt.zero_grad()
        d_total.backward()
        all_reduce_grads(st.disc_opt.params, average=True)
        st.disc_opt.step()

        # the generator's loss against the updated discriminators, which
        # take no gradient from it
        for p in st.disc_opt.params:
            p.requires_grad_(False)
        try:
            mel_l1 = torch.mean(torch.abs(self.mel_of(y_hat) - mel_target))
            pr, pg, fpr, fpg = st.mpd(audio, y_hat)
            sr, sg, fsr, fsg = st.msd(audio, y_hat)
            adv = generator_adversarial_loss(pg) + generator_adversarial_loss(sg)
            fm = feature_matching_loss(fpr, fpg) + feature_matching_loss(fsr, fsg)
            g_total = adv + fm + c.mel_loss_weight * mel_l1
            st.gen_opt.zero_grad()
            g_total.backward()
            all_reduce_grads(st.gen_opt.params, average=True)
            st.gen_opt.step()
        finally:
            for p in st.disc_opt.params:
                p.requires_grad_(True)

        if st.gen_ema is not None:
            with torch.no_grad():
                d = c.ema_decay
                torch._foreach_mul_(st.gen_ema, d)
                torch._foreach_add_(st.gen_ema, torch._foreach_mul(st.gen_opt.params, 1.0 - d))
        st.step += 1
        losses = {k: v.detach().clone() for k, v in
                  {"d_total": d_total, "d_mpd": d_mpd, "d_msd": d_msd, "g_adv": adv, "g_fm": fm,
                   "mel_l1": mel_l1, "g_total": g_total}.items()}
        all_reduce_tensors(list(losses.values()), average=True)
        return losses

    # ------------------------------------------------------------ checkpoints
    def _tree(self, state_dict: dict, ema=None) -> dict:
        """A generator state_dict (its parameters replaced by `ema`, tensors in
        their order, when given) as the flax-layout tree of `vocoder_tree`."""
        if ema is not None:
            names = [n for n, _ in self.state.gen.named_parameters()]
            state_dict = {**state_dict, **dict(zip(names, ema))}
        return vocoder_tree(self.family, state_dict)

    def full_state_arrays(self) -> dict[str, np.ndarray]:
        st = self.state
        arrays: dict[str, torch.Tensor] = {"step": torch.tensor(st.step)}
        for tag, m in (("gen", st.gen), ("mpd", st.mpd), ("msd", st.msd)):
            arrays.update({f"{tag}/{n}": p.detach().cpu() for n, p in m.state_dict().items()})
        arrays.update(st.gen_opt.state_arrays("gen_opt"))
        arrays.update(st.disc_opt.state_arrays("disc_opt"))
        if st.gen_ema is not None:
            arrays.update({f"gen_ema/{i}": e.detach().cpu() for i, e in enumerate(st.gen_ema)})
        return {k: v.numpy() for k, v in arrays.items()}

    def save(self, step: int) -> None:
        """Write <ckpt>/<step>/: `generator.npz` (the serving artifact),
        `generator_ema.npz` with the EMA on, `full_state.npz` and
        `sampler_state.json` (the sampler's RNG position: without it a
        resumed run would replay the segment stream). Resume with the EMA
        setting the run was saved with."""
        if self.ckpt_dir is None:
            return
        if not is_primary():
            barrier("vocoder checkpoint")
            return
        final = self.ckpt_dir / str(step)
        tmp = self.ckpt_dir / f".{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        sd = self.state.gen.state_dict()
        save_npz(tmp / "generator.npz", self._tree(sd))
        if self.state.gen_ema is not None:
            save_npz(tmp / "generator_ema.npz", self._tree(sd, self.state.gen_ema))
        np.savez(tmp / "full_state.npz", **self.full_state_arrays())
        (tmp / "sampler_state.json").write_text(json.dumps(self.sampler.rng.bit_generator.state))
        shutil.rmtree(final, ignore_errors=True)
        tmp.rename(final)
        barrier("vocoder checkpoint")

    def restore(self, step: int | None = None) -> int:
        """Resume from <ckpt>/<step> (the latest step when None): every
        parameter, both optimizers, the schedule's position, the EMA and the
        sampler's RNG position. A step holding `HALTED.json` (the
        watchdog's diverged state) is refused. Returns the restored step."""
        if self.ckpt_dir is None:
            raise ValueError("no ckpt_dir configured")
        if step is None:
            steps = (sorted(int(p.name) for p in self.ckpt_dir.iterdir()
                            if p.is_dir() and p.name.isdigit())
                     if self.ckpt_dir.is_dir() else [])
            if not steps:
                raise FileNotFoundError(f"no checkpoints in {self.ckpt_dir}")
            step = steps[-1]
        d = self.ckpt_dir / str(step)
        if (d / "HALTED.json").exists():
            raise ValueError(
                f"checkpoint {d} is a divergence halt state (HALTED.json present) — not "
                "resumable; use the generator_last_healthy artifact beside it or an earlier "
                "periodic step")
        with np.load(d / "full_state.npz") as f:
            arrays = {k: torch.from_numpy(f[k]) for k in f.files}
        st = self.state
        for tag, m in (("gen", st.gen), ("mpd", st.mpd), ("msd", st.msd)):
            m.load_state_dict({n[len(tag) + 1:]: v for n, v in arrays.items()
                               if n.startswith(tag + "/")})
        st.gen_opt.load_state_arrays("gen_opt", arrays)
        st.disc_opt.load_state_arrays("disc_opt", arrays)
        if st.gen_ema is not None:
            st.gen_ema = [arrays[f"gen_ema/{i}"].to(self.device).clone()
                          for i in range(len(st.gen_ema))]
        st.step = int(arrays["step"])
        sampler_state = d / "sampler_state.json"
        if sampler_state.exists():
            self.sampler.rng.bit_generator.state = json.loads(sampler_state.read_text())
        return st.step

    # ------------------------------------------------------------ watchdog
    def _check_divergence(self, step: int, m: dict) -> bool:
        """Update the watchdog from one log window's metrics; True the first
        time divergence is found. Triggers (the reference's): a non-finite
        loss, at once; mel_l1 above divergence_factor x the running best for
        divergence_patience windows in a row (a late collapse); past
        divergence_warmup_windows, a window that sets no new best with mel_l1
        above divergence_mel_ceiling counts as bad too (an early collapse);
        mel_l1 bit-identical over frozen_patience + 1 windows in a row."""
        if self.diverged_at is not None:
            return False                       # fires once
        c = self.cfg
        vals = [m.get(k) for k in ("mel_l1", "g_total", "d_total")]
        finite = all(v is not None and math.isfinite(v) for v in vals)
        mel = m.get("mel_l1")
        self._windows_seen += 1
        if finite and self._last_mel is not None and mel == self._last_mel:
            self._frozen_windows += 1
        else:
            self._frozen_windows = 0
        self._last_mel = mel if finite else None
        if not finite:
            self._bad_windows = c.divergence_patience      # no recovery
        else:
            if mel < self._best_mel_l1:
                self._best_mel_l1 = mel
                bad, improved = False, True
            else:
                bad, improved = mel > c.divergence_factor * self._best_mel_l1, False
            if (not improved and self._windows_seen > c.divergence_warmup_windows
                    and mel > c.divergence_mel_ceiling):
                bad = True
            self._bad_windows = self._bad_windows + 1 if bad else 0
        if (self._bad_windows < c.divergence_patience
                and self._frozen_windows < c.frozen_patience):
            return False
        self.diverged_at = step
        return True

    def _maybe_snapshot_healthy(self) -> None:
        """In halt mode, every healthy_snapshot_windows healthy log windows,
        a host copy of the generator (and its EMA) for `_save_last_healthy`."""
        c = self.cfg
        if (c.on_divergence != "halt" or c.healthy_snapshot_windows <= 0
                or self.ckpt_dir is None or self.diverged_at is not None
                or self._bad_windows or self._frozen_windows):
            return
        self._healthy_windows += 1
        if self._healthy_windows % c.healthy_snapshot_windows:
            return
        st = self.state
        ema = [e.detach().cpu().clone() for e in st.gen_ema] if st.gen_ema is not None else None
        self._healthy_snapshot = (
            st.step, {k: v.detach().cpu().clone() for k, v in st.gen.state_dict().items()}, ema)

    def _save_last_healthy(self, halt_step: int) -> str:
        """Write the healthy snapshot (if any) beside the halt checkpoint as
        `generator_last_healthy[_ema].npz`; a line for the halt message."""
        if self.ckpt_dir is None:
            return "no ckpt_dir configured"
        if self._healthy_snapshot is None:
            return ("no healthy snapshot was taken (healthy_snapshot_windows=0 or the run "
                    "never completed a healthy window) — restart from the last periodic "
                    "checkpoint")
        hstep, hgen, hema = self._healthy_snapshot
        d = self.ckpt_dir / str(halt_step)
        save_npz(d / "generator_last_healthy.npz", self._tree(hgen))
        if hema is not None:
            save_npz(d / "generator_last_healthy_ema.npz", self._tree(hgen, hema))
        return (f"generator_last_healthy (step {hstep}) is saved alongside it — serve/resume "
                "from that artifact")

    # ------------------------------------------------------------ loop
    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device, non_blocking=True)

    def train(self, steps: int | None = None) -> GANTrainState:
        """Train until the state's step reaches `steps` (cfg.total_steps by
        default): total-step semantics, so a restored trainer continues. A
        trainer halted by the watchdog stays halted."""
        c = self.cfg
        if self.diverged_at is not None and c.on_divergence == "halt":
            return self.state
        target = steps if steps is not None else c.total_steps
        step = done0 = self.state.step
        t0 = time.perf_counter()
        while step < target:
            batch = self.sampler.next_batch()
            if isinstance(batch, tuple):               # paired fine-tuning
                audio, mel = (shard_batch_multiprocess({"x": x})["x"] for x in batch)
                metrics = self.train_step(self._to_device(audio), self._to_device(mel))
            else:
                metrics = self.train_step(
                    self._to_device(shard_batch_multiprocess({"x": batch})["x"]))
            step += 1
            if step % c.log_every == 0 or step == target:
                m = {k: float(v) for k, v in metrics.items()}
                rate = (step - done0) / (time.perf_counter() - t0)
                line = (f"vocoder step {step}: mel_l1={m['mel_l1']:.4f} g={m['g_total']:.3f} "
                        f"d={m['d_total']:.3f} ({rate:.2f} steps/s)")
                if is_primary():
                    print(line)
                if self.log is not None:
                    self.log.scalars(step, m, prefix="Vocoder")
                    self.log.text(line)
                if self._check_divergence(step, m):
                    warn = (f"vocoder DIVERGENCE detected at step {step}: mel_l1="
                            f"{m['mel_l1']:.4f} vs running best {self._best_mel_l1:.4f} "
                            f"(factor {c.divergence_factor}, patience "
                            f"{c.divergence_patience} windows). GAN collapse does not "
                            "self-recover — restart from a healthy checkpoint with "
                            "grad_clip_norm=1e3 and/or a lower learning rate (family_recipe "
                            "has the stabilized defaults).")
                    print(warn)
                    if self.log is not None:
                        self.log.text(warn)
                    if c.on_divergence == "halt":
                        self.save(step)
                        note = self._save_last_healthy(step) if is_primary() else ""
                        if self.ckpt_dir is not None and is_primary():
                            # restore() refuses this step: a fresh process
                            # would reset the watchdog's running best
                            (self.ckpt_dir / str(step) / "HALTED.json").write_text(
                                json.dumps({"diverged_at": step, "mel_l1": m["mel_l1"]}))
                        print(f"vocoder halt: the step-{step} checkpoint is the DIVERGED "
                              f"state (forensics only); {note}")
                        return self.state
                else:
                    self._maybe_snapshot_healthy()
            if step % c.save_every == 0 or step == target:
                self.save(step)
        return self.state
