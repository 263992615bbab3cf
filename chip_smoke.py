#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`visual_onoma_to_wave_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure raises and exits non-zero:

  1. probe: torch / CUDA versions, the card and its power limit, TF32 flags;
  2. kernel: builds `csrc/flash_mha.cu` (nvcc, sm_90a) and holds the
     attention kernel against its plain PyTorch version at the path's shapes;
     times both at the serving decoder shape;
  3. golden: the committed demo weights (`examples/checkpoints/demo/torch/`)
     through the port's fused acoustic + vocoder step, against the JAX
     package's outputs stored in `golden.npz`;
  4. full width: the ICASSP configuration (hidden 256, 4 + 6 layers, dk 128,
     max_mel_len 1000) with HiFi-GAN V1, random weights from a seed, serving
     one padded batch of 16 requests; prints acoustic and synthesis rates.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Imports nothing of JAX and nothing of the
JAX package (`visual_onoma_to_wave_tpu`), so the HTTP server, which the port
reuses from that package, is checked on the card by
`tests/test_torch_served_cuda.py` instead.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
DEMO = ROOT / "examples" / "checkpoints" / "demo"
# ICASSP B16 (phase 4): batch, characters, max_mel_len, hop, sample rate,
# frames per character
B, C, MAX_MEL, HOP, SR, FRAMES = 16, 8, 1000, 256, 22050, 60

# kernel vs plain tolerances: fp32 differs only in summation order (online
# softmax over 64-key tiles vs one softmax); bf16 also rounds the
# probabilities at other points, and both sides round the result to bf16
# (one bf16 ulp relative = 2**-7)
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def time_cuda(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call, CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_probe() -> dict:
    from visual_onoma_to_wave_tpu_torch.precision import pin_fp32

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    flags = pin_fp32()
    say("1 probe", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi, **flags)
    return {"smi": smi}


def _attn_inputs(B, T, H, dk, dtype, mask_kind, gen, dev):
    q, k, v = (torch.randn(B, T, H * dk, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    if mask_kind == "none":
        return q, k, v, None, []
    lens = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
    lens[0] = T
    full = []
    if mask_kind == "full":
        full = [1, B - 1]
        lens[full] = 0
    mask = torch.arange(T, device=dev)[None, :] >= lens[:, None]
    return q, k, v, mask, full


def phase_kernel(dev, card: str) -> dict:
    from visual_onoma_to_wave_tpu_torch.ops.attention import (
        attention_core, attention_core_reference)

    gen = torch.Generator(device=dev).manual_seed(0)
    H = 2
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = 0
    for dk in (64, 128):
        for T in (8, 100, 512, 1000):
            for dtype in (torch.float32, torch.bfloat16):
                for kind in ("none", "tail", "full"):
                    q, k, v, mask, full = _attn_inputs(8, T, H, dk, dtype, kind, gen, dev)
                    out = attention_core(q, k, v, mask, H)
                    ref = attention_core_reference(q, k, v, mask, H)
                    torch.cuda.synchronize()
                    if out.shape != ref.shape or out.dtype != ref.dtype:
                        raise AssertionError(f"kernel shape/dtype {out.shape} {out.dtype} "
                                             f"!= plain {ref.shape} {ref.dtype}")
                    err = (out.float() - ref.float()).abs()
                    bound = ATOL[dtype] + RTOL[dtype] * ref.float().abs()
                    if not bool(torch.isfinite(out.float()).all()) or bool((err > bound).any()):
                        raise AssertionError(
                            f"kernel != plain at B=8 T={T} H={H} dk={dk} {dtype} "
                            f"mask={kind}: max abs err {err.max().item():.3e}")
                    for b in full:
                        if bool((out[b] != 0).any()):
                            raise AssertionError(f"fully padded item {b} is not exactly 0 "
                                                 f"(T={T} dk={dk} {dtype})")
                    worst[dtype] = max(worst[dtype], err.max().item())
                    cases += 1

    # time at the serving decoder shape (ICASSP: B=16, T=max_mel_len=1000,
    # H=2, dk=128), fp32, a tail key mask; alternate kernel and plain
    q, k, v, mask, _ = _attn_inputs(16, 1000, H, 128, torch.float32, "tail", gen, dev)
    run_k = lambda: attention_core(q, k, v, mask, H)  # noqa: E731
    run_p = lambda: attention_core_reference(q, k, v, mask, H)  # noqa: E731
    err = (run_k() - run_p()).abs().max().item()
    worst[torch.float32] = max(worst[torch.float32], err)
    ks, ps = [], []
    for order in ((run_k, ks, run_p, ps), (run_p, ps, run_k, ks)):
        order[1].append(time_cuda(order[0], 20))
        order[3].append(time_cuda(order[2], 20))
    ms, plain_ms = float(np.mean(ks)), float(np.mean(ps))
    say("2 kernel", card=card, cases=cases, max_abs_err_fp32=worst[torch.float32],
        max_abs_err_bf16=worst[torch.bfloat16], atol=dict(fp32=1e-5, bf16=2e-2),
        shape_timed="B=16 T=1000 H=2 dk=128 fp32", kernel_ms=ms, plain_ms=plain_ms,
        kernel_ms_runs=ks, plain_ms_runs=ps)
    return {"max_abs_err": worst[torch.float32], "ms": ms, "plain_ms": plain_ms}


def demo_models(dev):
    """The demo acoustic model and vocoder from the committed `.npz` trees,
    sized from the demo's JSON files (torch and numpy only: no config module)."""
    from visual_onoma_to_wave_tpu_torch.bridge import hifigan_state_dict, load_npz, vtts_state_dict
    from visual_onoma_to_wave_tpu_torch.models import VTTS, get_vocoder

    cfg = json.loads((DEMO / "config.json").read_text())
    pre = DEMO / "preprocessed"
    meta = {n: json.loads((pre / f"{n}.json").read_text())
            for n in ("symbols", "audiotype", "stats", "visual_text")}
    m, t = cfg["model"], cfg["model"]["transformer"]
    model = VTTS(
        n_vocab=len(meta["symbols"]), n_audiotype=len(meta["audiotype"]),
        hidden=t["encoder_hidden"], encoder_layers=t["encoder_layer"],
        decoder_layers=t["decoder_layer"], n_head=t["encoder_head"],
        decoder_n_head=t["decoder_head"], d_inner=t["conv_filter_size"],
        max_seq_len=m["max_seq_len"], max_mel_len=cfg["train"]["max_mel_len"],
        vfe_layers=m["visual_feature_extractor"]["layer_num"],
        cell_hw=(meta["visual_text"]["height"][0], meta["visual_text"]["max_pixelsize"][0]),
        energy_stats=tuple(meta["stats"]["energy"]),
        kurtosis_stats=tuple(meta["stats"]["kurtosis"]), postnet_dim=m["postnet_channels"])
    model.load_state_dict(vtts_state_dict(load_npz(DEMO / "torch" / "acoustic.npz")))
    gen = get_vocoder("HiFi-GAN", **m["vocoder_kwargs"])
    gen.load_state_dict(hifigan_state_dict(load_npz(DEMO / "torch" / "vocoder.npz")))
    return model.to(dev).eval(), gen.to(dev).eval()


def phase_golden(dev) -> None:
    from visual_onoma_to_wave_tpu_torch.ops.attention import attention_core
    from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer

    model, gen = demo_models(dev)
    fused = make_fused_infer(model, gen)
    g = dict(np.load(DEMO / "torch" / "golden.npz"))
    batch = {k: torch.from_numpy(g[k]).to(dev)
             for k in ("audiotypes", "texts", "src_lens", "image_cells")}
    ctl = {k: torch.from_numpy(g[k]).to(dev) for k in ("e_control", "d_control")}
    calls = 2
    before = attention_core.launches
    for _ in range(calls):
        out = fused(batch, **ctl)
    torch.cuda.synchronize()
    launches = attention_core.launches - before
    per_call = len(model.encoder.layer_stack) + len(model.decoder.layer_stack)
    if launches != per_call * calls:
        raise AssertionError(f"attention kernel launched {launches} times in {calls} "
                             f"calls; expected {per_call} per call")
    durations = out["duration_rounded"].cpu().numpy()
    mel_lens = out["mel_lens"].cpu().numpy()
    if not np.array_equal(durations, g["duration_rounded"]):
        flips = np.argwhere(durations != g["duration_rounded"]).tolist()
        raise AssertionError(f"durations differ from the JAX golden at {flips}: "
                             f"{durations.tolist()} vs {g['duration_rounded'].tolist()}")
    if not np.array_equal(mel_lens, g["mel_lens"]):
        raise AssertionError(f"mel_lens {mel_lens} != JAX golden {g['mel_lens']}")
    # fp32 with TF32 off: the two frameworks differ in summation order only
    errs = {k: float(np.abs(out[k].float().cpu().numpy() - g[k]).max())
            for k in ("postnet_mel", "wav")}
    for k, tol in (("postnet_mel", 1e-3), ("wav", 1e-3)):
        if errs[k] > tol:
            raise AssertionError(f"{k} differs from the JAX golden by {errs[k]:.3e} > {tol}")
    say("3 golden", items=int(len(mel_lens)), mel_lens=mel_lens.tolist(),
        durations_exact=True, max_abs_err=errs, atol=1e-3,
        kernel_launches_per_call=launches // calls)


def icassp_b16(dev):
    """ICASSP acoustic model (the `Config()` defaults = configs/icassp.yaml)
    and HiFi-GAN V1, random weights from seed 0, and one padded batch of 16
    requests of 8 characters. Returns (model, vocoder, batch) on `dev`."""
    from visual_onoma_to_wave_tpu_torch.models import VTTS, get_vocoder

    torch.manual_seed(0)
    model = VTTS(n_vocab=64, n_audiotype=10, max_mel_len=MAX_MEL)
    # each character predicts ~FRAMES frames (exp(log d) - 1), as bench.py
    # biases its durations, so the decoder and vocoder see realistic lengths
    dur = model.variance_adaptor.duration_predictor.linear_layer
    with torch.no_grad():
        dur.weight.mul_(0.01)
        dur.bias.fill_(float(np.log(FRAMES + 1)))
    gen = get_vocoder("HiFi-GAN")
    for mod in gen.modules():
        if isinstance(mod, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            torch.nn.init.normal_(mod.weight, 0.0, 0.01)  # the reference's init
    rng = np.random.default_rng(0)
    batch = {
        "audiotypes": torch.from_numpy((np.arange(B) % 10).astype(np.int64)),
        "texts": torch.from_numpy(rng.integers(1, 64, (B, C)).astype(np.int64)),
        "src_lens": torch.full((B,), C, dtype=torch.int64),
        "image_cells": torch.from_numpy(rng.uniform(0, 1, (B, C, 24, 102)).astype(np.float32)),
    }
    return model.to(dev).eval(), gen.to(dev).eval(), {k: v.to(dev) for k, v in batch.items()}


def phase_full(dev, card: str) -> dict:
    from visual_onoma_to_wave_tpu_torch.ops.attention import attention_core
    from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer

    model, gen, batch = icassp_b16(dev)
    fused = make_fused_infer(model, gen)
    attention_core.launches = 0
    out = fused(batch)
    torch.cuda.synchronize()
    launches = attention_core.launches
    per_call = len(model.encoder.layer_stack) + len(model.decoder.layer_stack)
    if launches != per_call:
        raise AssertionError(f"attention kernel launched {launches} times in one call; "
                             f"expected {per_call}")
    wav, mel_lens = out["wav"], out["mel_lens"].cpu().numpy()
    if tuple(wav.shape) != (B, MAX_MEL * HOP) or not bool(torch.isfinite(wav).all()):
        raise AssertionError(f"waveform {tuple(wav.shape)} finite={bool(torch.isfinite(wav).all())}")
    if not ((mel_lens > 0) & (mel_lens <= MAX_MEL)).all():
        raise AssertionError(f"mel_lens out of range: {mel_lens}")
    # each item's audio is what Synthesizer.synthesize_batch returns for it
    for i, n in enumerate(mel_lens):
        item = wav[i, :int(n) * HOP]
        if item.numel() != int(n) * HOP or not bool(item.any()):
            raise AssertionError(f"item {i}: {item.numel()} samples for mel_len {n}, "
                                 f"nonzero={bool(item.any())}")
    if not bool(torch.isfinite(out["postnet_mel"]).all()):
        raise AssertionError("postnet mel is not finite")

    acoustic = lambda: model(batch["audiotypes"], batch["texts"], batch["src_lens"],  # noqa: E731
                             image_cells=batch["image_cells"])
    with torch.inference_mode():
        acoustic_ms = time_cuda(acoustic, 5, warmup=2)
    fused_ms = time_cuda(lambda: fused(batch), 5, warmup=2)
    frames = int(mel_lens.sum())
    audio_s = frames * HOP / SR
    say("4 full width", card=card, config="ICASSP (Config() defaults) + HiFi-GAN V1, random seed 0",
        batch=B, chars=C, max_mel_len=MAX_MEL, mel_lens=mel_lens.tolist(),
        kernel_launches_per_call=launches, acoustic_ms=acoustic_ms, synthesis_ms=fused_ms,
        acoustic_mel_frames_per_s=frames / (acoustic_ms / 1e3),
        synthesis_x_realtime=audio_s / (fused_ms / 1e3),
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return {"launches": launches}


def main() -> int:
    probe = phase_probe()
    dev = torch.device("cuda", 0)
    kern = phase_kernel(dev, probe["smi"])
    phase_golden(dev)
    full = phase_full(dev, probe["smi"])

    record = {"kernels": [{
        "name": "flash_mha",
        "route": "cuda",
        "source": "visual_onoma_to_wave_tpu_torch/csrc/flash_mha.cu",
        "replaces": "visual_onoma_to_wave_tpu/ops/pallas_attention.py:130",
        "launches": full["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
    }]}
    print(probe["smi"])
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
