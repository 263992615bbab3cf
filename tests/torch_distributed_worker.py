"""One process of the port's data-parallel tests (tests/test_torch_distributed.py).

    python tests/torch_distributed_worker.py MODE RANK WORLD PORT OUT [ARG]

Joins a gloo process group of WORLD processes on 127.0.0.1:PORT (none when
WORLD is 1), runs MODE and writes its result to OUT (an .npz):

  step     3 acoustic train steps (`train_state.train_step`, dropout on,
           BatchNorm in the VFE and the PostNet) on one fixed global batch
           whose halves hold different valid counts;
  gan      2 GAN steps of a tiny `VocoderTrainer` on one global batch, then
           `train()` to step 3 with a checkpoint directory (ARG);
  trainer  the acoustic `Trainer` on the corpus of the config at ARG: 2
           steps with a checkpoint, then a new trainer resumed from it to 4.

The test runs the same functions in its own process with WORLD 1 for the
reference.
"""
from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

B, C, T, N_MELS = 4, 4, 32, 16
TINY = dict(n_vocab=10, n_audiotype=3, hidden=32, encoder_layers=1, decoder_layers=1,
            n_head=2, d_inner=64, ffn_kernel=(3, 1), max_seq_len=64, max_mel_len=T,
            n_mels=N_MELS, vfe_layers=1, is_energy=True, is_kurtosis=False,
            energy_stats=(-2.0, 2.0, 0.0, 1.0))
OPT = dict(init_lr=1e-2, warmup_steps=10, grad_clip=1.0)
GEN = dict(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
           upsample_initial_channel=16, resblock_kernel_sizes=(3,), resblock_dilations=((1, 2),))
TINY_MPD = dict(periods=(2, 3), channels=(4, 8))
TINY_MSD = dict(n_scales=2, channels=4)
GAN_LOSSES = ("d_total", "d_mpd", "d_msd", "g_adv", "g_fm", "mel_l1", "g_total")


def global_batch() -> dict:
    """B 4 with valid text lengths 4, 3 | 4, 2 and mel lengths 32, 25 | 20,
    16: the two halves hold different valid counts."""
    rng = np.random.default_rng(0)
    lens = np.array([4, 3, 4, 2], np.int32)
    texts = rng.integers(1, 10, (B, C)).astype(np.int32)
    texts[np.arange(C)[None, :] >= lens[:, None]] = 0
    return {"audiotypes": rng.integers(0, 3, B).astype(np.int32), "texts": texts,
            "src_lens": lens, "mels": rng.standard_normal((B, T, N_MELS)).astype(np.float32),
            "energies": rng.standard_normal((B, C)).astype(np.float32),
            "durations": np.array([[8, 8, 8, 8], [10, 6, 9, 0], [5, 5, 5, 5], [7, 9, 0, 0]],
                                  np.int32),
            "image_cells": rng.uniform(0, 1, (B, C, 8, 16)).astype(np.float32)}


def run_step(world: int) -> dict:
    from visual_onoma_to_wave_tpu_torch.models.vtts import VTTS
    from visual_onoma_to_wave_tpu_torch.parallel import (
        host_tree,
        process_index,
        shard_batch_multiprocess,
    )
    from visual_onoma_to_wave_tpu_torch.training.schedule import NoamAdam
    from visual_onoma_to_wave_tpu_torch.training.train_state import TrainState, train_step

    torch.manual_seed(0)
    model = VTTS(**TINY, use_image=True, cell_hw=(8, 16))
    state = TrainState(model, NoamAdam(model.parameters(), **OPT),
                       torch.Generator().manual_seed(1),
                       shard=(process_index(), world) if world > 1 else None)
    batch = {k: torch.from_numpy(v) for k, v in shard_batch_multiprocess(global_batch()).items()}
    # the processes' rows, gathered, are the global batch's
    out = {"gathered_src_lens": host_tree({"src_lens": batch["src_lens"]})["src_lens"]}
    for i in range(3):
        losses = train_step(state, batch)
        for k, v in losses.items():
            out[f"loss{i}/{k}"] = float(v)
        for n, p in model.named_parameters():
            out[f"grad{i}/{n}"] = p.grad.numpy().copy()
        if i == 0:      # the BatchNorms' running statistics after one step
            out.update({f"stats0/{n}": b.numpy().copy() for n, b in model.named_buffers()
                        if "running" in n})
    out.update({f"state/{k}": v.numpy().copy() for k, v in model.state_dict().items()})
    return out


def run_gan(world: int, ckpt_dir: str) -> dict:
    from visual_onoma_to_wave_tpu_torch.models.hifigan import HiFiGANGenerator
    from visual_onoma_to_wave_tpu_torch.models.hifigan_disc import (
        MultiPeriodDiscriminator,
        MultiScaleDiscriminator,
    )
    from visual_onoma_to_wave_tpu_torch.parallel import shard_batch_multiprocess
    from visual_onoma_to_wave_tpu_torch.training.vocoder_trainer import (
        VocoderTrainConfig,
        VocoderTrainer,
    )

    clip = np.random.default_rng(5).normal(0, 0.2, 9000).astype(np.float32)
    cfg = VocoderTrainConfig(segment_size=2048, batch_size=4, log_every=1, save_every=10 ** 9,
                             ema_decay=0.9, grad_clip_norm=1.0)
    vt = VocoderTrainer([clip], cfg, gen=HiFiGANGenerator(**GEN), ckpt_dir=ckpt_dir,
                        mpd=MultiPeriodDiscriminator(**TINY_MPD),
                        msd=MultiScaleDiscriminator(**TINY_MSD), device="cpu")
    batch = vt.sampler.next_batch()
    out = {}
    for i in range(2):
        m = vt.train_step(torch.from_numpy(shard_batch_multiprocess({"x": batch})["x"]))
        out.update({f"loss{i}/{k}": float(m[k]) for k in GAN_LOSSES})
    vt.train(steps=3)
    out.update({f"gen/{k}": v.numpy().copy() for k, v in vt.gen.state_dict().items()})
    out.update({f"ema/{i}": e.numpy().copy() for i, e in enumerate(vt.state.gen_ema)})
    out["step"] = vt.state.step
    return out


def run_trainer(world: int, cfg_path: str, run_dir: str) -> dict:
    import dataclasses

    from visual_onoma_to_wave_tpu_torch.config import config_from_dict
    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer
    from visual_onoma_to_wave_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = config_from_dict(json.loads(pathlib.Path(cfg_path).read_text()))
    run = pathlib.Path(run_dir)
    cfg = cfg.replace(path=dataclasses.replace(cfg.path, ckpt=str(run / "ckpt"),
                                               log=str(run / "log"),
                                               result=str(run / "result")))
    saves = []
    save = CheckpointManager.save

    def counted(self, state, step=None):
        saves.append(state.step)
        return save(self, state, step)

    CheckpointManager.save = counted
    losses: list[float] = []
    try:
        Trainer(cfg, device="cpu", loader_workers=0).train(
            max_steps=2, on_step=lambda s, l: losses.append(float(l["total_loss"])))
        trainer = Trainer(cfg, restore_step=-1, device="cpu", loader_workers=0)
        restored = trainer.state.step
        trainer.train(max_steps=4, on_step=lambda s, l: losses.append(float(l["total_loss"])))
        val = trainer.evaluate()
    finally:
        CheckpointManager.save = save
    out = {"losses": np.array(losses), "restored": restored, "saves": np.array(saves),
           "val_total": val["total_loss"]}
    out.update({f"state/{k}": v.numpy().copy()
                for k, v in trainer.state.model.state_dict().items()})
    return out


def main(argv: list[str]) -> int:
    mode, rank, world, port, out = argv[:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    if world > 1:
        from visual_onoma_to_wave_tpu_torch.parallel import init_distributed

        init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu", timeout_s=120)
    if mode == "step":
        result = run_step(world)
    elif mode == "gan":
        result = run_gan(world, argv[5])
    elif mode == "trainer":
        result = run_trainer(world, argv[5], argv[6])
    else:
        raise SystemExit(f"unknown mode {mode}")
    np.savez(out, **result)
    if world > 1:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
