#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`visual_onoma_to_wave_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one or two lines; any failure raises and exits non-zero:

  1. probe: torch / CUDA versions, the card and its power limit, TF32 flags;
     then every kernel source (`csrc/flash_mha.cu`, `csrc/convnext.cu`) is
     built with nvcc for sm_90a, one nvcc process each, all at once;
  2. kernel: holds the attention kernel against its plain PyTorch version at
     the path's shapes; times both at the serving decoder shape;
  2b. convnext: holds the ConvNeXt block and trunk kernels against their
     plain versions (fp32 and bf16, tanh and erf GELU, T 20 / 512 / 1000,
     demo and full widths, L 4 and 8) and the trunk against L block
     launches; times block vs plain and trunk vs 8 blocks vs plain at the
     full served shape;
  3. golden: the committed demo weights (`examples/checkpoints/demo/torch/`)
     through the port's fused acoustic + vocoder step, against the JAX
     package's outputs stored in `golden.npz`;
  4. full width: the ICASSP configuration (hidden 256, 4 + 6 layers, dk 128,
     max_mel_len 1000) with HiFi-GAN V1, random weights from a seed, serving
     one padded batch of 16 requests; prints acoustic and synthesis rates;
  5. vocos golden: phase 3 with the demo Vocos (`config_vocos.json`,
     `vocoder_vocos.npz`) against `golden_vocos.npz`, and `apply_fused`
     (one trunk launch) against the served waveform;
  6. vocos full width: phase 4's acoustic model and batch with the published
     mel-Vocos widths (dim 512, intermediate 1536, 8 blocks, n_fft 1024),
     random weights from a seed, beside phase 4's HiFi-GAN numbers.

Each path (phases 4, 5, 6) is driven with every launch count set to 0 just
before it and read just after.

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
# ConvNeXt kernels vs plain, block and trunk: fp32 differs in summation
# order over the C and M products, 5e-5 absolute for |y| up to ~6; bf16
# rounds h, a and y to bf16 in both, where an order difference can flip a
# rounding that later layers carry on, so bf16 is held to the JAX package's
# own bound for this kernel: max error within 0.03 of max |plain|
# (tests/test_pallas_convnext.py:49)
CONVNEXT_ATOL = {torch.float32: 5e-5}
CONVNEXT_BF16_OF_SCALE = 0.03
# ConvNeXt widths (C, M): the demo Vocos and the published mel-Vocos
CONVNEXT_WIDTHS = ((128, 384), (512, 1536))


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
    import time

    from visual_onoma_to_wave_tpu_torch.ops.cuda_build import build_libraries
    from visual_onoma_to_wave_tpu_torch.precision import pin_fp32

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    flags = pin_fp32()
    t0 = time.perf_counter()
    libs = build_libraries()
    say("1 probe", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=smi, **flags,
        build_s=time.perf_counter() - t0,
        libraries=[str(p.relative_to(ROOT)) for p in libs.values()])
    return {"smi": smi}


def zero_launch_counts() -> None:
    from visual_onoma_to_wave_tpu_torch.ops.attention import attention_core
    from visual_onoma_to_wave_tpu_torch.ops.convnext import convnext_block, convnext_trunk

    for kernel in (attention_core, convnext_block, convnext_trunk):
        kernel.launches = 0


def launch_counts() -> dict:
    from visual_onoma_to_wave_tpu_torch.ops.attention import attention_core
    from visual_onoma_to_wave_tpu_torch.ops.convnext import convnext_block, convnext_trunk

    return {"flash_mha": attention_core.launches, "convnext_block": convnext_block.launches,
            "convnext_trunk": convnext_trunk.launches}


def expect_launches(phase: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{phase}: kernel launches {got}, expected {want}")


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


def convnext_weights(L, C, M, gen, dev):
    """Stacked (L, ...) ConvNeXt weights at a scale that keeps every stage
    O(1) (the layer outputs reach |y| ~ 6), so that errors show."""
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale
    return (r(L, 7, 1, C, scale=0.3), r(L, C, scale=0.1), 1 + r(L, C, scale=0.1),
            r(L, C, scale=0.1), r(L, C, M, scale=C ** -0.5), r(L, M, scale=0.1),
            r(L, M, C, scale=M ** -0.5), r(L, C, scale=0.1), r(L, C, scale=0.5))


def convnext_atol(ref: torch.Tensor) -> float:
    """The ConvNeXt kernels' absolute tolerance against the plain `ref`."""
    if ref.dtype == torch.bfloat16:
        return CONVNEXT_BF16_OF_SCALE * max(ref.float().abs().max().item(), 1e-3)
    return CONVNEXT_ATOL[ref.dtype]


def _check_close(what: str, out, ref) -> float:
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{what}: kernel {tuple(out.shape)} {out.dtype} != "
                             f"plain {tuple(ref.shape)} {ref.dtype}")
    err = (out.float() - ref.float()).abs().max().item()
    if not bool(torch.isfinite(out.float()).all()) or err > convnext_atol(ref):
        raise AssertionError(f"{what}: kernel != plain, max abs err {err:.3e} "
                             f"> {convnext_atol(ref):.3e}")
    return err


def phase_convnext(dev, card: str) -> dict:
    from visual_onoma_to_wave_tpu_torch.ops.convnext import (
        convnext_block, convnext_block_reference, convnext_trunk, convnext_trunk_reference)

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {(k, d): 0.0 for k in ("block", "trunk") for d in (torch.float32, torch.bfloat16)}
    cases = 0
    for C, M in CONVNEXT_WIDTHS:
        for T in (20, 512, 1000):
            for dtype in (torch.float32, torch.bfloat16):
                for tanh in (True, False):
                    x = torch.randn(2, T, C, generator=gen, device=dev).to(dtype)
                    for L in (4, 8):
                        ws = convnext_weights(L, C, M, gen, dev)
                        what = f"C={C} M={M} T={T} {dtype} gelu={'tanh' if tanh else 'erf'}"
                        if L == 4:
                            w0 = [w[0] for w in ws]
                            out = convnext_block(x, *w0, gelu_approximate=tanh)
                            ref = convnext_block_reference(x, *w0, gelu_approximate=tanh)
                            torch.cuda.synchronize()
                            err = _check_close(f"convnext_block {what}", out, ref)
                            worst["block", dtype] = max(worst["block", dtype], err)
                            cases += 1
                        out = convnext_trunk(x, *ws, gelu_approximate=tanh)
                        ref = convnext_trunk_reference(x, *ws, gelu_approximate=tanh)
                        blocks = x
                        for layer in zip(*ws):
                            blocks = convnext_block(blocks, *layer, gelu_approximate=tanh)
                        torch.cuda.synchronize()
                        err = _check_close(f"convnext_trunk L={L} {what}", out, ref)
                        worst["trunk", dtype] = max(worst["trunk", dtype], err)
                        if not torch.equal(out, blocks):
                            raise AssertionError(f"convnext_trunk L={L} {what} differs from "
                                                 f"{L} convnext_block launches")
                        cases += 1

    # time at the full served shape: B 16, T 1000 (ICASSP max_mel_len), the
    # published widths, 8 blocks, fp32; alternate kernel and plain
    L, (C, M) = 8, CONVNEXT_WIDTHS[-1]
    x = torch.randn(B, MAX_MEL, C, generator=gen, device=dev)
    ws = convnext_weights(L, C, M, gen, dev)
    w0 = [w[0] for w in ws]

    def eight_blocks():
        y = x
        for layer in zip(*ws):
            y = convnext_block(y, *layer)
        return y

    runs = {"block": lambda: convnext_block(x, *w0),
            "block_plain": lambda: convnext_block_reference(x, *w0),
            "trunk": lambda: convnext_trunk(x, *ws),
            "eight_blocks": eight_blocks,
            "trunk_plain": lambda: convnext_trunk_reference(x, *ws)}
    full_err = {"block": _check_close("convnext_block full shape", runs["block"](),
                                      runs["block_plain"]()),
                "trunk": _check_close("convnext_trunk full shape", runs["trunk"](),
                                      runs["trunk_plain"]())}
    times = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            times[k].append(time_cuda(runs[k], 5, warmup=2))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    worst["block", torch.float32] = max(worst["block", torch.float32], full_err["block"])
    worst["trunk", torch.float32] = max(worst["trunk", torch.float32], full_err["trunk"])
    faster = min(("trunk", "eight_blocks", "trunk_plain"), key=ms.get)
    say("2b convnext", card=card, cases=cases,
        max_abs_err={f"{k}_{str(d).split('.')[-1]}": v for (k, d), v in worst.items()},
        tol={"fp32_atol": CONVNEXT_ATOL[torch.float32], "bf16_of_max_abs": CONVNEXT_BF16_OF_SCALE},
        trunk_equals_block_launches=True,
        shape_timed=f"B={B} T={MAX_MEL} C={C} M={M} L={L} fp32", ms=ms, ms_runs=times,
        fastest_of_trunk_forms=faster)
    return {"block": {"max_abs_err": worst["block", torch.float32], "ms": ms["block"],
                      "plain_ms": ms["block_plain"]},
            "trunk": {"max_abs_err": worst["trunk", torch.float32], "ms": ms["trunk"],
                      "plain_ms": ms["trunk_plain"]}}


def demo_models(dev, config: str = "config.json", vocoder: str = "vocoder.npz"):
    """The demo acoustic model and vocoder from the committed `.npz` trees,
    sized from the demo's JSON files (torch and numpy only: no config module).
    The vocoder family and widths come from `config` (config.json: HiFi-GAN;
    config_vocos.json: Vocos), its weights from `torch/<vocoder>`."""
    from visual_onoma_to_wave_tpu_torch.bridge import load_npz, vocoder_state_dict, vtts_state_dict
    from visual_onoma_to_wave_tpu_torch.models import VTTS, get_vocoder

    cfg = json.loads((DEMO / config).read_text())
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
    family = m.get("vocoder_model", "HiFi-GAN")
    gen = get_vocoder(family, **m["vocoder_kwargs"])
    gen.load_state_dict(vocoder_state_dict(family, load_npz(DEMO / "torch" / vocoder)))
    return model.to(dev).eval(), gen.to(dev).eval()


def convnext_blocks(gen) -> int:
    """ConvNeXt block launches per vocoder call (0 for HiFi-GAN)."""
    return len(getattr(gen, "blocks", ()))


def phase_golden(dev, phase: str = "3 golden", config: str = "config.json",
                 vocoder: str = "vocoder.npz", golden: str = "golden.npz") -> dict:
    from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer

    model, gen = demo_models(dev, config, vocoder)
    fused = make_fused_infer(model, gen)
    g = dict(np.load(DEMO / "torch" / golden))
    batch = {k: torch.from_numpy(g[k]).to(dev)
             for k in ("audiotypes", "texts", "src_lens", "image_cells")}
    ctl = {k: torch.from_numpy(g[k]).to(dev) for k in ("e_control", "d_control")}
    calls = 2
    per_call = {"flash_mha": len(model.encoder.layer_stack) + len(model.decoder.layer_stack),
                "convnext_block": convnext_blocks(gen), "convnext_trunk": 0}
    zero_launch_counts()
    for _ in range(calls):
        out = fused(batch, **ctl)
    torch.cuda.synchronize()
    expect_launches(phase, launch_counts(), {k: n * calls for k, n in per_call.items()})
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
    say(phase, items=int(len(mel_lens)), mel_lens=mel_lens.tolist(),
        durations_exact=True, max_abs_err=errs, atol=1e-3, kernel_launches_per_call=per_call)
    return {"gen": gen, "out": out}


def phase_vocos_golden(dev) -> None:
    """Phase 3 on the demo Vocos, then the whole trunk as one launch
    (`apply_fused`) on the same mel, against the served waveform."""
    from visual_onoma_to_wave_tpu_torch.models.vocos import apply_fused

    phase = "5 vocos golden"
    served = phase_golden(dev, phase, "config_vocos.json", "vocoder_vocos.npz",
                          "golden_vocos.npz")
    zero_launch_counts()
    wav = apply_fused(served["gen"], served["out"]["postnet_mel"])
    torch.cuda.synchronize()
    expect_launches(f"{phase} apply_fused", launch_counts(),
                    {"flash_mha": 0, "convnext_block": 0, "convnext_trunk": 1})
    # the trunk runs the block kernel's code per tile: the same waveform
    err = (wav - served["out"]["wav"]).abs().max().item()
    if err > 1e-6:
        raise AssertionError(f"{phase}: apply_fused differs from the served vocoder by {err:.3e}")
    say(phase + " apply_fused", trunk_launches=1, max_abs_err_vs_served=err, atol=1e-6)


def icassp_b16(dev, vocoder: str = "HiFi-GAN"):
    """ICASSP acoustic model (the `Config()` defaults = configs/icassp.yaml)
    and a vocoder at its published widths (HiFi-GAN V1, or Vocos: dim 512,
    intermediate 1536, 8 blocks), random weights from seed 0, and one padded
    batch of 16 requests of 8 characters. Returns (model, vocoder, batch) on
    `dev`; the acoustic model and batch do not depend on the vocoder."""
    from visual_onoma_to_wave_tpu_torch.models import VTTS, get_vocoder

    torch.manual_seed(0)
    model = VTTS(n_vocab=64, n_audiotype=10, max_mel_len=MAX_MEL)
    # each character predicts ~FRAMES frames (exp(log d) - 1), as bench.py
    # biases its durations, so the decoder and vocoder see realistic lengths
    dur = model.variance_adaptor.duration_predictor.linear_layer
    with torch.no_grad():
        dur.weight.mul_(0.01)
        dur.bias.fill_(float(np.log(FRAMES + 1)))
    gen = get_vocoder(vocoder)
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


def phase_full(dev, card: str, phase: str = "4 full width", vocoder: str = "HiFi-GAN",
               beside: dict | None = None) -> tuple[dict, tuple]:
    """Serve one padded ICASSP batch of 16 through the fused step with
    `vocoder` at full width; check each item's audio; time it. Returns the
    numbers and (vocoder module, outputs of the checked call)."""
    from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer

    torch.cuda.reset_peak_memory_stats()
    model, gen, batch = icassp_b16(dev, vocoder)
    fused = make_fused_infer(model, gen)
    per_call = {"flash_mha": len(model.encoder.layer_stack) + len(model.decoder.layer_stack),
                "convnext_block": convnext_blocks(gen), "convnext_trunk": 0}
    zero_launch_counts()
    out = fused(batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    expect_launches(phase, launches, per_call)
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
    result = {"acoustic_ms": acoustic_ms, "synthesis_ms": fused_ms,
              "acoustic_mel_frames_per_s": frames / (acoustic_ms / 1e3),
              "synthesis_x_realtime": audio_s / (fused_ms / 1e3),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    extra = {}
    if beside is not None:
        extra["hifigan_v1"] = {k: beside[k] for k in ("acoustic_ms", "synthesis_ms",
                                                      "synthesis_x_realtime", "peak_mem_gib")}
    say(phase, card=card,
        config=f"ICASSP (Config() defaults) + {vocoder} at published widths, random seed 0",
        batch=B, chars=C, max_mel_len=MAX_MEL, mel_lens=mel_lens.tolist(),
        kernel_launches_per_call=launches, **result, **extra)
    return {"launches": launches, **result}, (gen, out)


def phase_vocos_full(dev, card: str, hifigan: dict) -> dict:
    """Phase 4 with Vocos at the published widths, then `apply_fused` (one
    trunk launch) on the same mel against the served waveform, and the two
    vocoder forms timed in turns."""
    from visual_onoma_to_wave_tpu_torch.models.vocos import apply_fused

    phase = "6 vocos full width"
    served, (gen, out) = phase_full(dev, card, phase, "Vocos", beside=hifigan)
    mel = out["postnet_mel"]
    zero_launch_counts()
    wav = apply_fused(gen, mel)
    torch.cuda.synchronize()
    trunk = launch_counts()
    expect_launches(f"{phase} apply_fused", trunk,
                    {"flash_mha": 0, "convnext_block": 0, "convnext_trunk": 1})
    err = (wav - out["wav"]).abs().max().item()
    if err > 1e-6:
        raise AssertionError(f"{phase}: apply_fused differs from the served vocoder by {err:.3e}")
    runs = {"blocks": lambda: gen(mel), "trunk": lambda: apply_fused(gen, mel)}
    times = {k: [] for k in runs}
    with torch.inference_mode():
        for order in (("blocks", "trunk"), ("trunk", "blocks")):
            for k in order:
                times[k].append(time_cuda(runs[k], 5, warmup=2))
    say(phase + " apply_fused", card=card, trunk_launches=trunk["convnext_trunk"],
        max_abs_err_vs_served=err, atol=1e-6,
        vocoder_ms={k: float(np.mean(v)) for k, v in times.items()}, vocoder_ms_runs=times)
    return {"block_launches": served["launches"]["convnext_block"],
            "trunk_launches": trunk["convnext_trunk"]}


def main() -> int:
    probe = phase_probe()
    dev = torch.device("cuda", 0)
    attn = phase_kernel(dev, probe["smi"])
    convnext = phase_convnext(dev, probe["smi"])
    phase_golden(dev)
    full, _ = phase_full(dev, probe["smi"])
    phase_vocos_golden(dev)
    vocos = phase_vocos_full(dev, probe["smi"], full)

    source = "visual_onoma_to_wave_tpu_torch/csrc/"
    tpu = "visual_onoma_to_wave_tpu/ops/"
    record = {"kernels": [
        {"name": "flash_mha", "route": "cuda", "source": source + "flash_mha.cu",
         "replaces": tpu + "pallas_attention.py:130",
         "launches": full["launches"]["flash_mha"], **attn},
        {"name": "convnext_block", "route": "cuda", "source": source + "convnext.cu",
         "replaces": tpu + "pallas_convnext.py:138",
         "launches": vocos["block_launches"], **convnext["block"]},
        {"name": "convnext_trunk", "route": "cuda", "source": source + "convnext.cu",
         "replaces": tpu + "pallas_convnext.py:230",
         "launches": vocos["trunk_launches"], **convnext["trunk"]},
    ]}
    print(probe["smi"])
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
