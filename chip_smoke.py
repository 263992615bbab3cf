#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`visual_onoma_to_wave_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Phases, each printing one or two lines; any failure raises and exits non-zero:

  1. probe: torch / CUDA versions, the card and its power limit, TF32 flags;
     then every kernel source (`csrc/flash_mha.cu`, `csrc/convnext.cu`,
     `csrc/mel_frontend.cu`, `csrc/mrf.cu`) is built with nvcc for sm_90a,
     one nvcc process each, all at once;
  2. kernel: holds the attention kernel against its plain PyTorch version
     over dk 64 / 128, fp32 / bf16, T 8 / 63 / 64 / 65 / 100 / 129 / 512 /
     1000 and key masks none / tail / full / holes (fully padded items exactly
     0; in bf16 at most BF16_DIFFER_SHARE of the elements differ, the kernel
     rounding where the plain version does); at the serving decoder shape
     (B 16, T 1000, H 2, dk 128), in fp32 and
     in bf16, times kernel, plain and `scaled_dot_product_attention` under
     random tail lengths, and after phase 4 under its mel lengths, beside the
     tensor-core bound (fp32 as 3xTF32) and the fp32 CUDA-core bound;
  2b. convnext: holds the ConvNeXt block and trunk kernels against their
     plain versions (fp32 and bf16, tanh and erf GELU, T 20 / 63 / 64 / 65 /
     129 / 512 / 1000 around the 64-frame tile, demo and full widths, L 4 and
     8) and the trunk against L block launches; at the full served shape, in
     fp32 and in bf16, times block vs plain and trunk vs 8 blocks vs plain,
     and the library chain in the same type (cuDNN depthwise conv,
     LayerNorm, cuBLAS products), with the weights packed once as the served
     path packs them; prints achieved TFLOP/s beside the fp32 CUDA-core
     bound and the tensor-core bound (3xTF32 for fp32, bf16);
  3. golden: the committed demo weights (`examples/checkpoints/demo/torch/`)
     through the port's fused acoustic + vocoder step, against the JAX
     package's outputs stored in `golden.npz`; the demo HiFi-GAN runs its
     four MRF stages (C 64 / 32 / 16 / 8) through the MRF kernel;
  4. full width: the ICASSP configuration (hidden 256, 4 + 6 layers, dk 128,
     max_mel_len 1000) with HiFi-GAN V1 (four MRF kernel launches a call),
     random weights from a seed, serving one padded batch of 16 requests;
     prints acoustic and synthesis rates;
  5. vocos golden: phase 3 with the demo Vocos (`config_vocos.json`,
     `vocoder_vocos.npz`) against `golden_vocos.npz`, and `apply_fused`
     (one trunk launch) against the served waveform;
  6. vocos full width: phase 4's acoustic model and batch with the published
     mel-Vocos widths (dim 512, intermediate 1536, 8 blocks, n_fft 1024),
     random weights from a seed, beside phase 4's HiFi-GAN numbers;
  7. mel frontend: holds the fused mel kernel and `fused_clip_features`
     against their plain versions, and the kernel's log-mel within 1e-5 of
     float64, over the case grid of tests/test_pallas_mel.py (adversarial
     inputs included) and over every n_fft the kernel takes (16 ... 2048, B
     3, a clip shorter than a block's frames and one of three blocks);
     prints ptxas's registers and spills per instantiation of the kernel and
     fails on any spill; then drives pass 1 of corpus preprocessing
     (`data/features.extract_features`) over 640 seeded clips of 0.3-6 s in
     length-sorted 64-clip batches, one kernel launch per batch, each
     batch's log-mel within 1e-5 of float64; prints the feature stage's
     clips/s and frames/s with the kernel and with the plain version, and
     kernel vs plain vs `torch.stft` + mel product in fp32 and in float64
     (with the frame sums) ms at one 64-clip batch of the largest bucket,
     beside the bound at each operation's own rate (float64 for the FFT and
     each bin's power) and at the fp32 rate;
  8. mrf: ptxas's registers and spills of each one-pass and unit-design
     instantiation; holds the fused MRF stage kernel against its plain
     version (the cuDNN 18-conv chain, also the library yardstick) over fp32
     / bf16, C 8 / 16 / 32 / 64 / 128 / 256 / 512, T 20 (inside the 60-frame
     halo), one frame either side of the conv chain's time tile and on it
     (and of the one-pass kernel's frame tile at C <= 64 and the unit
     design's at C 64-256), and 1000, B 1 / 4, each call counted on the
     design `mrf_route` gives its shape; in bf16 every design built for the
     width (the one-pass kernel at C <= 64, the unit design at C 64-256) on
     the same operands under the same bound, the worst error printed per
     width and the largest gap to the conv chain's output; times the kernel
     (fp32 and bf16, weights packed once), the plain version in fp32 and
     bf16, the bf16 `ResBlock1` modules (`library_bf16`) and every bf16
     design built for the width, at the served stage shapes of iSTFTNet (C
     512 x T 1000, 256 x 8000, 128 x 64000) and of HiFi-GAN V1 (256 x 8000,
     128 x 64000, 64 x 128000, 32 x 256000), B 16, beside the fp32
     CUDA-core, 3xTF32 and bf16 tensor-core bounds and the bytes and work
     each design's structure moves and does;
  9. istftnet golden: phase 3 with the demo iSTFTNet-mel
     (`config_istftnet.json`, `vocoder_istftnet_mel.npz`) against
     `golden_istftnet.npz`, one MRF launch per call;
  10. istftnet full width: phase 4's acoustic model and batch with
     iSTFTNet-mel (512 channels) and iSTFTNet C8C8I (512 initial channels),
     random weights from a seed, beside phase 4's HiFi-GAN numbers;
  11. melgan full width: the same with MelGAN at the melgan-neurips widths
     (no kernel of the vocoder; the acoustic model's attention only);
  12. served: the port's own `serve.BatchingServer` over the demo
     iSTFTNet-mel on the card, 4 concurrent HTTP requests;
  13. acoustic training: the port's synthetic corpus (2 classes x 24 clips)
     through its `format`, `prepare-tg` and `Preprocessor` (saving the clips'
     audio) on the card (B3 launches printed); the ICASSP model (`configs/icassp.yaml` geometry,
     parameter count printed) trained by the port's `Trainer` at batch 16 in
     fp32 for 200 steps (warm_up_step 40; evaluate with metrics at 100 and
     200; checkpoints at 100 and 200). Checks: the first step's loss terms
     and grad norm on the card against the same step on the CPU with every
     dropout rate 0 (1e-4 relative); every loss and grad norm finite; the
     mean total loss of the last 20 steps below the first 20's; no attention
     kernel launch in the train steps, some in evaluate. Prints the step's
     median ms (CUDA events recorded by the trainer's `on_step` callback:
     the period from one step's end to the next's, the batch's load and copy
     included, over the steps that neither evaluate nor save), mel frames/s
     and peak memory. Then a fresh
     `Trainer(restore_step=-1)` restores the parameters bit for bit and takes
     one more step, and `Synthesizer.from_checkpoint` serves
     `<ckpt>/200/acoustic.npz` with finite mels through the attention kernel;
  14. bigvgan full width: phase 4 with BigVGAN base (random weights N(0,
     0.01), log-alpha / log-beta 0; no hand-written kernel: convs, AA FIRs
     and snake run as PyTorch ops), beside phase 4's HiFi-GAN numbers; the
     same weights without anti-aliasing (the AA's share of the vocoder ms);
     the AA FIRs' device time from a `torch.profiler` pass; the card against the
     same module on the CPU at B 2 x T 64; then the large preset (1536
     channels, rates 4, 4, 2, 2, 2, 2) at B16, checked against the CPU at B
     1 x T 16;
  15. chunked and vocode: `vocoder_infer_chunked` (chunk 256 frames) on
     phase 4's first 4 mels (T 1000) through HiFi-GAN V1, iSTFTNet-mel,
     Vocos and BigVGAN base at published widths, one forward over every
     window (MRF / ConvNeXt kernel launches counted), the interior against
     the full forward, and the whole waveform against the same windows
     through the plain path on the card (no kernel launched); then
     `Synthesizer.vocode` on the demo HiFi-GAN fed the golden requests' mels
     cut to their lengths, against the fused path's waveforms away from
     their last halo x hop samples; then `cli synthesize-batch` on the card
     with the demo checkpoint (5 rows, 2 batches), each file of mel_len x
     hop samples and within one 16-bit step of `synthesize_batch`;
  16. quality gate and demo server: `tools/eval_quality_demo_torch.py`'s
     functions on the card (the demo corpus of 2 x 60 clips built with the
     mel kernel, `evaluate(metrics=True)` of the demo acoustic model with the
     attention kernel, copy-synthesis through the committed HiFi-GAN and
     iSTFTNet-mel with the MRF kernel and Vocos with the ConvNeXt block
     kernel, launches counted for each), then the same gate on the CPU, and
     every gate number of the card within 1e-2 relative of the CPU's; then
     the port's `DemoServer` on the demo checkpoint answering four
     /api/synthesize requests after an untimed cold one (a wav of
     mel_frames x 256 samples each, the strip and the mel figure as PNGs;
     attention and MRF launches counted);
  17. vocoder training: the port's `VocoderTrainer` on the corpus of
     `tools/vocoder_longrun_torch.py` (20 clips), fp32. (a) HiFi-GAN V1 at
     full width against MPD + MSD at full width, B 16 x 8192 samples, its
     recipe with the EMA on: 3 warm-up and 20 timed GAN steps (CUDA events;
     ms per step, audio-s/s, peak memory), every loss finite, no kernel
     launched. (b) The first GAN step on the card against the CPU at B 2 from
     the same initial state and batch: the D and G losses and the gradients'
     global norms within VOC_FIRST_RTOL. (c) The trainer saved and restored
     into a fresh one bit for bit (parameters, both optimizers, EMA, sampler);
     a step holding HALTED.json refused; the saved generator.npz through
     `synthesis.load_vocoder` in `.eval()` vocodes phase 4's first 4 mels with
     one MRF launch per stage, within VOCODE_ATOL of the plain chain. (d)
     iSTFTNet-mel (MPD + MSD) and BigVGAN base (MPD + MRD), their recipe (lr
     1e-4, clip 1e3), 5 steps each at B 16 x 8192, no launch. (e)
     `teacher_forced_pairs` over phase 13's checkpoint and corpus (phase 13
     preprocesses with saved audio and keeps its work directory for this):
     one attention launch per FFT block and train batch, held exactly; then
     5 paired fine-tuning steps, no launch.

  18. export: the demo synthesizer exported for `cuda` (`export.py`,
     `torch.export` with the kernels as custom ops), loaded in a fresh
     `ExportedSynthesizer`, serving the 4 golden requests against the live
     path (EXPORT_ATOL) and 4 HTTP requests through `BatchingServer`; the
     ICASSP B16 synthesizers of phase 4 (HiFi-GAN V1: B1 10 and B2 4
     launches a call through the artifact; mel-Vocos: B4 8) exported and
     run at phase 4's batch against the live fused step, artifact and live
     ms (CUDA events), export and load seconds and artifact bytes printed;
  19. scale-out on one card: an nccl process group of one, one
     data-parallel train step of phase 4's acoustic model (global BatchNorm
     statistics and loss counts, the gradient all-reduce, dropout on)
     against the plain step from the same state (DP_LOSS_RTOL,
     DP_PARAM_ATOL), both timed; `parallel.make_sharded_synth` over the
     card's device list against the live batch. Nothing measures NCCL across
     GPUs.
  20. bf16: phase 4's acoustic model as `train.compute_dtype: bfloat16`
     builds it, with bf16 HiFi-GAN V1, iSTFTNet-mel and mel-Vocos
     (`get_vocoder(..., dtype=torch.bfloat16)`), the same weights, at phase
     4's batch: B1 10, B2 4 (HiFi-GAN V1: the conv chain at C 256 / 128,
     the unit design at C 64, the one-pass kernel at C 32, by `mrf_route`
     on each stage's shape) / 1 and B4 8 launches a call, every kernel's
     operands bf16; each path against the same bf16 path with the plain
     versions on the card and against fp32 (the bounds above
     `BF16_VS_PLAIN_OF_SCALE`), the mel's reading beside plain bf16 against
     fp32 on the same durations; synthesis, acoustic and vocoder ms, x real
     time and peak GiB beside the fp32 numbers of phases 4, 6 and 10. Then
     three bf16 train steps of phase 4's model beside three fp32 steps on
     the same batch, and bf16 GAN steps of HiFi-GAN V1 with MPD + MSD at B
     16 x 8192 (losses finite, parameters fp32, no launch), beside phases 13
     and 17's fp32 steps; then the bf16 HiFi-GAN V1 synthesizer exported and
     run against the live bf16 step.
  21. the rest of the JAX package's surface: phase 13's checkpoint served
     through `Synthesizer.from_checkpoint(restore_step=-1)` bit for bit as
     through its `acoustic.npz`, with the checkpoint's vocabulary, and `cli
     synthesize --restore-step -1` in a subprocess on the card (a wav of mel
     frames x 256 samples); phase 4's batch and an odd batch of 5 requests
     over two replicas on the card against one (B1 and B2 launched per
     replica); B3 over two shares of phase 7's first 64 clips (two launches,
     the log-mel bit for bit); phase 13's trainer resumed with a `torch.profiler` trace
     over three steps (its five longest device operations printed) and the
     sample's mel + energy figure; `griffin_lim` on the card against the CPU.

Each path (phases 4-7, 9-21) is driven with every launch count set to 0 just
before it and read just after. The full `Preprocessor.build` on the card is
checked by `tests/test_torch_preprocess_cuda.py`.

The line before the last is the kernels' JSON record (each kernel's
launches on its main path, its error against the plain version, kernel,
plain and library ms and the card's bound at the timed shape, and the bf16
launches of phase 20 as `launches_bf16`; the MRF stage's one-pass kernel,
`mrf_stage_onepass`, and its unit design, `mrf_stage_unit`, each with its
launches in phase 20's bf16 HiFi-GAN V1 and its numbers at its served
shape (C 32 x T 256000, C 64 x T 128000) beside the conv chain's, the unit
design also at C 128 and 256 where the route keeps the chain; for the
attention, ConvNeXt and MRF kernels the bound is that of the tensor cores,
fp32 as 3xTF32, with the fp32 CUDA-core bound and the bf16 numbers beside
it, and for attention the same numbers under the served mask; for the mel
kernel the float64 operations at the float64 rate, with the bound at the
fp32 rate, the float64 library call, the log-mel's distance to float64 and
ptxas's registers and spills beside it); the last line
is `{"ok": true, "device": {...}}`. Imports nothing of JAX and nothing of the
JAX package (`visual_onoma_to_wave_tpu`).
"""
from __future__ import annotations

import contextlib
import functools
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
DEMO = ROOT / "examples" / "checkpoints" / "demo"
# ICASSP B16 (phase 4): batch, characters, max_mel_len, hop, sample rate,
# frames per character
B, C, MAX_MEL, HOP, SR, FRAMES = 16, 8, 1000, 256, 22050, 60

# attention kernel vs plain tolerances: fp32 differs in summation order
# (online softmax over 64-key tiles vs one softmax) and in the kernel's
# 3xTF32 products (~2**-21 relative each); bf16 also rounds the
# probabilities at other points, and both sides round the result to bf16
# (one bf16 ulp relative = 2**-7)
ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RTOL = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7}
# bf16 attention: the kernel rounds where the plain version (and the TPU
# kernel) round, so the two differ by roundoff alone: now and then one
# probability's bf16 rounding flips, which moves every output of its row by
# a fraction of an ulp and flips some of them. The share of output elements
# that differ is bounded by 5e-3: the plain version and the TPU kernel
# (interpret mode), both rounding at that point, differ in up to 1.49e-3 of
# the elements on random inputs at T 1000 (tests/test_torch_attention_bf16.py),
# and a rounding at another point differs in 11-50% of them
BF16_DIFFER_SHARE = 5e-3
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
# the ConvNeXt parity cases' T: short, around one and two 64-frame tiles, long
CONVNEXT_T = (20, 63, 64, 65, 129, 512, 1000)
# the card's peaks for the bounds (NVIDIA H100 SXM data sheet, dense, at the
# full 700 W): fp32 and float64 outside the tensor cores, TF32 and bf16 on
# the tensor cores, and HBM3
PEAK_FP32_FLOPS, PEAK_TF32_FLOPS, PEAK_BF16_FLOPS = 67e12, 495e12, 989e12
PEAK_FP64_FLOPS = 34e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations over
    `peak_flops` (by default the fp32 peak outside the tensor cores) and the
    bytes (each input read once, each output written once) over the memory
    rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
        libraries=[str(p.relative_to(ROOT)) for p in libs.values()],
        tensor_core_instructions={name: sass_mma_counts(path) for name, path in libs.items()})
    return {"smi": smi}


def sass_mma_counts(library: pathlib.Path) -> dict | str:
    """Tensor-core instructions in a built library's machine code: wgmma
    (HGMMA) and mma.sync (HMMA), as `cuobjdump -sass` lists them."""
    import os
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        return "cuobjdump not found"
    sass = subprocess.run([tool, "-sass", str(library)], check=True, capture_output=True,
                          text=True).stdout
    return {op: sum(line.split()[1].startswith(op) for line in sass.splitlines()
                    if line.strip().startswith("/*") and len(line.split()) > 1)
            for op in ("HGMMA", "HMMA")}


def _wrappers() -> dict:
    """Every kernel wrapper of the port by its record name."""
    from visual_onoma_to_wave_tpu_torch.ops.attention import attention_core
    from visual_onoma_to_wave_tpu_torch.ops.convnext import convnext_block, convnext_trunk
    from visual_onoma_to_wave_tpu_torch.ops.mel import mel_frontend
    from visual_onoma_to_wave_tpu_torch.ops.mrf import (
        mrf_stage_fused, mrf_stage_onepass, mrf_stage_unit)

    return {"flash_mha": attention_core, "convnext_block": convnext_block,
            "convnext_trunk": convnext_trunk, "mel_frontend": mel_frontend,
            "mrf_stage": mrf_stage_fused, "mrf_stage_onepass": mrf_stage_onepass,
            "mrf_stage_unit": mrf_stage_unit}


# the record name of each design `ops/mrf.py::mrf_route` picks
MRF_RECORD = {"chain": "mrf_stage", "onepass": "mrf_stage_onepass", "unit": "mrf_stage_unit"}


def zero_launch_counts() -> None:
    for kernel in _wrappers().values():
        kernel.launches = 0


def launch_counts() -> dict:
    return {name: kernel.launches for name, kernel in _wrappers().items()}


def expect_launches(phase: str, got: dict, want: dict) -> None:
    """`want` lists the kernels the path launches; every other count must be 0."""
    want = {k: want.get(k, 0) for k in got}
    if got != want:
        raise AssertionError(f"{phase}: kernel launches {got}, expected {want}")


# the attention parity cases: T around the 64-key tile and the 128-query
# block, short (the encoder's T 8) and the decoder's max_mel_len; key masks
# none, tail (random lengths), full (two items fully padded) and holes
# (every other 64-key tile padding besides the tail: whole interior tiles
# that the kernel skips)
ATTN_T = (8, 63, 64, 65, 100, 129, 512, 1000)
ATTN_MASKS = ("none", "tail", "full", "holes")


def _attn_inputs(B, T, H, dk, dtype, mask_kind, gen, dev, lens=None):
    q, k, v = (torch.randn(B, T, H * dk, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    if mask_kind == "none":
        return q, k, v, None, []
    if lens is None:
        lens = torch.randint(1, T + 1, (B,), generator=gen, device=dev)
        lens[0] = T
    full = []
    if mask_kind == "full":
        full = [1, B - 1]
        lens[full] = 0
    t = torch.arange(T, device=dev)[None, :]
    mask = t >= lens[:, None]
    if mask_kind == "holes":   # even items lose tiles 1, 3, ..., odd items 0, 2, ...
        mask = mask | ((t // 64 + torch.arange(B, device=dev)[:, None]) % 2 == 1)
    return q, k, v, mask, full


def attention_costs(mask: torch.Tensor, H: int, dk: int, dtype, q) -> dict:
    """The card's bounds for one attention call, over the keys each query may
    see: both products (4 T Tk dk FLOPs per item and head); Q and the mask
    read, ctx written, and the valid keys' rows of K and V read, once each
    (padding keys' rows are not needed); on the tensor cores (fp32 as three
    TF32 products) and, for fp32, on the CUDA cores."""
    valid = int((~mask).sum().item())
    flops = 4.0 * H * dk * mask.shape[1] * valid
    moved = nbytes(q, mask) + nbytes(q) + 2 * valid * H * dk * q.element_size()
    tc = (bound(3 * flops, moved, PEAK_TF32_FLOPS) if dtype == torch.float32
          else bound(flops, moved, PEAK_BF16_FLOPS))
    return {"flops": flops, "tensor_cores": tc, "fp32_cuda_cores": bound(flops, moved)}


def phase_kernel(dev, card: str) -> dict:
    """Attention kernel vs plain over the parity grid, then timed under random
    tail lengths (`time_attention`). Returns the state that `time_attention`
    and `attention_record` take."""
    from visual_onoma_to_wave_tpu_torch.ops.attention import (
        attention_core, attention_core_reference)

    gen = torch.Generator(device=dev).manual_seed(0)
    H = 2
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_share = 0.0
    cases = 0
    for dk in (64, 128):
        for T in ATTN_T:
            for dtype in (torch.float32, torch.bfloat16):
                for kind in ATTN_MASKS:
                    q, k, v, mask, full = _attn_inputs(8, T, H, dk, dtype, kind, gen, dev)
                    out = attention_core(q, k, v, mask, H)
                    ref = attention_core_reference(q, k, v, mask, H)
                    torch.cuda.synchronize()
                    if out.shape != ref.shape or out.dtype != ref.dtype:
                        raise AssertionError(f"kernel shape/dtype {out.shape} {out.dtype} "
                                             f"!= plain {ref.shape} {ref.dtype}")
                    err = (out.float() - ref.float()).abs()
                    tol = ATOL[dtype] + RTOL[dtype] * ref.float().abs()
                    if not bool(torch.isfinite(out.float()).all()) or bool((err > tol).any()):
                        raise AssertionError(
                            f"kernel != plain at B=8 T={T} H={H} dk={dk} {dtype} "
                            f"mask={kind}: max abs err {err.max().item():.3e}")
                    for b in full:
                        if bool((out[b] != 0).any()):
                            raise AssertionError(f"fully padded item {b} is not exactly 0 "
                                                 f"(T={T} dk={dk} {dtype})")
                    if dtype == torch.bfloat16:
                        worst_share = max(worst_share, differ_share(out, ref, T, dk, kind))
                    worst[dtype] = max(worst[dtype], err.max().item())
                    cases += 1
    say("2 kernel parity", card=card, cases=cases, T=ATTN_T, masks=ATTN_MASKS,
        max_abs_err_fp32=worst[torch.float32], max_abs_err_bf16=worst[torch.bfloat16],
        bf16_differ_share=worst_share,
        tol={"fp32_atol": ATOL[torch.float32], "bf16_atol": ATOL[torch.bfloat16],
             "bf16_rtol": RTOL[torch.bfloat16], "bf16_differ_share": BF16_DIFFER_SHARE})
    attn = {"card": card, "gen": gen, "worst": worst, "share": worst_share, "timed": {}}
    time_attention(dev, attn, "tail")
    return attn


def differ_share(out: torch.Tensor, ref: torch.Tensor, T: int, dk: int, kind: str) -> float:
    """The share of bf16 output elements where the kernel and the plain
    version differ; raises above BF16_DIFFER_SHARE."""
    share = float((out != ref).float().mean())
    if share > BF16_DIFFER_SHARE:
        raise AssertionError(f"bf16 kernel differs from plain in {share:.3e} of the elements "
                             f"(T={T} dk={dk} mask={kind}; bound {BF16_DIFFER_SHARE})")
    return share


def time_attention(dev, attn: dict, kind: str, lens: torch.Tensor | None = None) -> None:
    """Kernel, plain and SDPA timed, in turns, in fp32 and bf16 at the serving
    decoder's shape (ICASSP B 16, T = max_mel_len 1000, H 2, dk 128) under
    one key mask: `kind` "tail" (random lengths) or "served" (phase 4's mel
    lengths `lens`). The kernel is held to the plain version there too; the
    errors and times go into `attn` (from `phase_kernel`)."""
    from visual_onoma_to_wave_tpu_torch.ops.attention import (
        attention_core, attention_core_reference)

    Bt, T, H, dk = 16, MAX_MEL, 2, 128
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v, mask, _ = _attn_inputs(Bt, T, H, dk, dtype, "tail", attn["gen"], dev,
                                        None if lens is None else lens.clone())
        heads = [t.reshape(Bt, T, H, dk).transpose(1, 2) for t in (q, k, v)]
        keep = ~mask[:, None, None, :]
        runs = {"kernel": lambda: attention_core(q, k, v, mask, H),
                "plain": lambda: attention_core_reference(q, k, v, mask, H),
                # timed only: a fully masked row gives NaN there, 0 in the port
                "library": lambda: torch.nn.functional.scaled_dot_product_attention(
                    *heads, attn_mask=keep)}
        plain, out = runs["plain"](), runs["kernel"]()
        ref = plain.float()
        err = (out.float() - ref).abs()
        if bool((err > ATOL[dtype] + RTOL[dtype] * ref.abs()).any()):
            raise AssertionError(f"kernel != plain at the timed shape {name} {kind}: "
                                 f"max abs err {err.max().item():.3e}")
        attn["worst"][dtype] = max(attn["worst"][dtype], err.max().item())
        share = None
        if dtype == torch.bfloat16:
            share = differ_share(out, plain, T, dk, kind)
            attn["share"] = max(attn["share"], share)
        times = {n: [] for n in runs}
        for order in (list(runs), list(runs)[::-1]):
            for n in order:
                times[n].append(time_cuda(runs[n], 20))
        ms = {n: float(np.mean(t)) for n, t in times.items()}
        cost = attention_costs(mask, H, dk, dtype, q)
        attn["timed"][name, kind] = {"ms": ms, **cost}
        say(f"2 kernel {name} {kind}", card=attn["card"],
            shape_timed=f"B={Bt} T={T} H={H} dk={dk} {name}, {kind} key mask",
            valid_keys=int((~mask).sum().item()), ms=ms, ms_runs=times,
            **({} if share is None else {"differ_share": share,
                                         "differ_share_bound": BF16_DIFFER_SHARE}),
            bounds={k_: cost[k_] for k_ in ("tensor_cores", "fp32_cuda_cores")},
            tflops={n: cost["flops"] / (t * 1e9) for n, t in ms.items()},
            share_of_tensor_core_bound=cost["tensor_cores"]["bound_ms"] / ms["kernel"],
            share_of_cuda_core_bound=cost["fp32_cuda_cores"]["bound_ms"] / ms["kernel"],
            kernel_vs_library=ms["library"] / ms["kernel"])


def attention_record(attn: dict) -> dict:
    """The attention kernel's numbers for the kernels' record: fp32 at the
    tail mask, with its CUDA-core bound, bf16 beside it, and both at the
    served mask."""
    timed, worst = attn["timed"], attn["worst"]

    def numbers(name: str, kind: str) -> dict:
        t = timed[name, kind]
        return {"ms": t["ms"]["kernel"], "plain_ms": t["ms"]["plain"],
                **t["tensor_cores"], "library_ms": t["ms"]["library"]}

    return {"max_abs_err": worst[torch.float32], **numbers("float32", "tail"),
            "bound_fp32_cuda_cores_ms": timed["float32", "tail"]["fp32_cuda_cores"]["bound_ms"],
            "bf16": {"max_abs_err": worst[torch.bfloat16], "differ_share": attn["share"],
                     **numbers("bfloat16", "tail")},
            "served_mask": {"fp32": numbers("float32", "served"),
                            "bf16": numbers("bfloat16", "served")}}


def convnext_weights(L, C, M, gen, dev):
    """Stacked (L, ...) ConvNeXt weights at a scale that keeps every stage
    O(1) (the layer outputs reach |y| ~ 6), so that errors show."""
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale
    return (r(L, 7, 1, C, scale=0.3), r(L, C, scale=0.1), 1 + r(L, C, scale=0.1),
            r(L, C, scale=0.1), r(L, C, M, scale=C ** -0.5), r(L, M, scale=0.1),
            r(L, M, C, scale=M ** -0.5), r(L, C, scale=0.1), r(L, C, scale=0.5))


def convnext_library(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, eps: float = 1e-6):
    """One ConvNeXt block (tanh GELU) as PyTorch library calls: cuDNN's
    depthwise conv, LayerNorm, cuBLAS products (the yardstick of B4; L of
    them of B5)."""
    F = torch.nn.functional
    K, C = dw.shape[0], x.shape[-1]
    h = F.conv1d(x.transpose(1, 2), dw.reshape(K, C).t()[:, None, :], db, padding=(K - 1) // 2,
                 groups=C).transpose(1, 2)
    h = F.layer_norm(h, (C,), ls, lb, eps)
    return x + gamma * F.linear(F.gelu(F.linear(h, w1.t(), b1), approximate="tanh"), w2.t(), b2)


def convnext_cost(x: torch.Tensor, layer_weights) -> tuple[float, int]:
    """(FLOPs, bytes) of one block: two products and the depthwise conv per
    frame; x read, y written, the block's weights read once."""
    B_, T_, C_ = x.shape
    K, M = layer_weights[0].numel() // C_, layer_weights[4].shape[-1]
    return B_ * T_ * (4.0 * C_ * M + 2.0 * K * C_), nbytes(x, x, *layer_weights)


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
        convnext_block, convnext_block_reference, convnext_trunk, convnext_trunk_reference,
        pack_convnext_weights)

    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {(k, d): 0.0 for k in ("block", "trunk") for d in (torch.float32, torch.bfloat16)}
    cases = 0
    for C, M in CONVNEXT_WIDTHS:
        for T in CONVNEXT_T:
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
    # published widths, 8 blocks, in fp32 and in bf16; alternate kernel and
    # plain. The kernels take the weights packed once, as the served path
    # (models/vocos.py) does; the library chain runs in the operand type.
    L, (C, M) = 8, CONVNEXT_WIDTHS[-1]
    timed, full_err = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        x = torch.randn(B, MAX_MEL, C, generator=gen, device=dev).to(dtype)
        ws = convnext_weights(L, C, M, gen, dev)
        w0 = [w[0] for w in ws]
        packed, packed0 = (pack_convnext_weights(ws[4], ws[6], dtype),
                           pack_convnext_weights(w0[4], w0[6], dtype))
        # the library chain in the operand type (its vectors too)
        lw = [w.to(dtype) for w in ws]
        lw0 = [w[0] for w in lw]

        def eight_blocks(x=x, ws=ws, packed=packed):
            y = x
            for layer, p in zip(zip(*ws), packed):
                y = convnext_block(y, *layer, packed=p)
            return y

        def eight_library(x=x, lw=lw):
            y = x
            for layer in zip(*lw):
                y = convnext_library(y, *layer)
            return y

        runs = {"block": lambda x=x, w0=w0, p=packed0: convnext_block(x, *w0, packed=p),
                "block_plain": lambda x=x, w0=w0: convnext_block_reference(x, *w0),
                "block_library": lambda x=x, lw0=lw0: convnext_library(x, *lw0),
                "trunk": lambda x=x, ws=ws, p=packed: convnext_trunk(x, *ws, packed=p),
                "eight_blocks": eight_blocks,
                "trunk_plain": lambda x=x, ws=ws: convnext_trunk_reference(x, *ws),
                "trunk_library": eight_library}
        errs = {"block": _check_close(f"convnext_block full shape {name}", runs["block"](),
                                      runs["block_plain"]()),
                "trunk": _check_close(f"convnext_trunk full shape {name}", runs["trunk"](),
                                      runs["trunk_plain"]()),
                # the bf16 chain rounds at other points (conv output, GELU
                # input): its error is printed, not held to the kernels' bound
                "library": (_check_close("convnext library chain fp32", runs["block_library"](),
                                         runs["block_plain"]()) if dtype == torch.float32 else
                            (runs["block_library"]().float()
                             - runs["block_plain"]().float()).abs().max().item())}
        times = {k: [] for k in runs}
        for order in (list(runs), list(runs)[::-1]):
            for k in order:
                times[k].append(time_cuda(runs[k], 5, warmup=2))
        ms = {k: float(np.mean(v)) for k, v in times.items()}
        worst["block", dtype] = max(worst["block", dtype], errs["block"])
        worst["trunk", dtype] = max(worst["trunk", dtype], errs["trunk"])
        flops, block_bytes = convnext_cost(x, [w.to(dtype) if i in (0, 4, 6) else w
                                               for i, w in enumerate(w0)])
        trunk_bytes = 2 * nbytes(x) + L * (block_bytes - 2 * nbytes(x))   # x, y, L layers
        # tensor cores: fp32 runs three TF32 products (3xTF32), bf16 one
        tc_flops, tc_peak = ((3 * flops, PEAK_TF32_FLOPS) if dtype == torch.float32
                             else (flops, PEAK_BF16_FLOPS))
        bounds = {"block": {"tensor_cores": bound(tc_flops, block_bytes, tc_peak),
                            "fp32_cuda_cores": bound(flops, block_bytes)},
                  "trunk": {"tensor_cores": bound(L * tc_flops, trunk_bytes, tc_peak),
                            "fp32_cuda_cores": bound(L * flops, trunk_bytes)}}
        timed[dtype] = {"ms": ms, "bounds": bounds}
        full_err[name] = errs
        say(f"2b convnext {name}", card=card,
            shape_timed=f"B={B} T={MAX_MEL} C={C} M={M} L={L} {name}", ms=ms, ms_runs=times,
            bounds=bounds, max_abs_err_full_shape=errs,
            tflops={k: n * flops / (ms[k] * 1e9) for k, n in
                    (("block", 1), ("block_library", 1), ("trunk", L), ("trunk_library", L))},
            share_of_tensor_core_bound={
                k: bounds[k]["tensor_cores"]["bound_ms"] / ms[k] for k in ("block", "trunk")},
            fastest_of_trunk_forms=min(("trunk", "eight_blocks", "trunk_plain",
                                        "trunk_library"), key=ms.get))
    say("2b convnext", card=card, cases=cases,
        max_abs_err={f"{k}_{str(d).split('.')[-1]}": v for (k, d), v in worst.items()},
        tol={"fp32_atol": CONVNEXT_ATOL[torch.float32], "bf16_of_max_abs": CONVNEXT_BF16_OF_SCALE},
        trunk_equals_block_launches=True, T=CONVNEXT_T)

    def record(kernel: str, plain: str, library: str) -> dict:
        fp32, bf16 = timed[torch.float32], timed[torch.bfloat16]
        return {"max_abs_err": worst[kernel, torch.float32], "ms": fp32["ms"][kernel],
                "plain_ms": fp32["ms"][plain], **fp32["bounds"][kernel]["tensor_cores"],
                "library_ms": fp32["ms"][library],
                "bound_fp32_cuda_cores_ms": fp32["bounds"][kernel]["fp32_cuda_cores"]["bound_ms"],
                "bf16": {"max_abs_err": worst[kernel, torch.bfloat16], "ms": bf16["ms"][kernel],
                         "plain_ms": bf16["ms"][plain], "library_ms": bf16["ms"][library],
                         **bf16["bounds"][kernel]["tensor_cores"]}}

    return {"block": record("block", "block_plain", "block_library"),
            "trunk": record("trunk", "trunk_plain", "trunk_library")}


def demo_models(dev, config: str = "config.json", vocoder: str = "vocoder.npz"):
    """The demo acoustic model and vocoder from the committed `.npz` trees,
    built from the demo config through the port's own config module. The
    vocoder family and widths come from `config` (config.json: HiFi-GAN;
    config_vocos.json: Vocos; config_istftnet.json: iSTFTNet-mel), its
    weights from `torch/<vocoder>`."""
    from visual_onoma_to_wave_tpu_torch.bridge import load_npz, vocoder_state_dict, vtts_state_dict
    from visual_onoma_to_wave_tpu_torch.config import DatasetMetadata, load_config
    from visual_onoma_to_wave_tpu_torch.data.symbols import load_symbol_map
    from visual_onoma_to_wave_tpu_torch.models import VTTS, get_vocoder

    cfg = load_config(DEMO / config)
    pre = DEMO / "preprocessed"
    model = VTTS.from_config(cfg, DatasetMetadata.load(pre), n_vocab=len(load_symbol_map(pre)))
    model.load_state_dict(vtts_state_dict(load_npz(DEMO / "torch" / "acoustic.npz")))
    family = cfg.model.vocoder_model
    gen = get_vocoder(family, **dict(cfg.model.vocoder_kwargs))
    gen.load_state_dict(vocoder_state_dict(family, load_npz(DEMO / "torch" / vocoder)))
    return model.to(dev).eval(), gen.to(dev).eval()


def convnext_blocks(gen) -> int:
    """ConvNeXt block launches per vocoder call (0 for HiFi-GAN)."""
    return len(getattr(gen, "blocks", ()))


def mrf_stages(gen, mel: tuple[int, int] | None = None) -> dict:
    """Fused MRF stage launches per vocoder call: one per ResBlock1 stage of
    iSTFTNet and HiFi-GAN V1 / V2 (the generators that keep an `MRFStages`),
    by the design `ops/mrf.py::mrf_route` gives the stage: the conv chain
    ("mrf_stage"), the one-pass kernel ("mrf_stage_onepass") or the unit
    design ("mrf_stage_unit"). `mel`: the (batch, frames) of the mel the
    generator is fed, for the route's size rule (each stage's frames the
    mel's times the upsampling before it; held against the card's SMs, or an
    H100's without a card); without it the width decides alone."""
    from visual_onoma_to_wave_tpu_torch.ops.mrf import SMS, mrf_route, sm_count

    counts = {name: 0 for name in MRF_RECORD.values()}
    stages = getattr(gen, "_mrf", None)
    if stages is not None:
        n = gen.num_kernels
        sms = sm_count(torch.device("cuda", 0)) if torch.cuda.is_available() else SMS
        for i in range(len(gen.resblocks) // n):
            C = gen.resblocks[i * n].convs1[0].out_channels
            batch, frames = (None, None) if mel is None else \
                (mel[0], mel[1] * int(np.prod(gen.upsample_rates[:i + 1], dtype=np.int64)))
            route = mrf_route(C, gen.dtype, stages.kernel_sizes, stages.dilations, batch, frames,
                              sms)
            counts[MRF_RECORD[route]] += 1
    return counts


def per_call_launches(model, gen, mel: tuple[int, int] | None = None) -> dict:
    """Kernel launches of one fused acoustic + vocoder call (`mel`: the
    (batch, frames) of the mel the vocoder is fed, see `mrf_stages`)."""
    return {"flash_mha": len(model.encoder.layer_stack) + len(model.decoder.layer_stack),
            "convnext_block": convnext_blocks(gen), "convnext_trunk": 0,
            **mrf_stages(gen, mel)}


def phase_golden(dev, phase: str = "3 golden", config: str = "config.json",
                 vocoder: str = "vocoder.npz", golden: str = "golden.npz",
                 wav_atol: float = 1e-3) -> dict:
    from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer

    model, gen = demo_models(dev, config, vocoder)
    fused = make_fused_infer(model, gen)
    g = dict(np.load(DEMO / "torch" / golden))
    batch = {k: torch.from_numpy(g[k]).to(dev)
             for k in ("audiotypes", "texts", "src_lens", "image_cells")}
    ctl = {k: torch.from_numpy(g[k]).to(dev) for k in ("e_control", "d_control")}
    calls = 2
    per_call = per_call_launches(model, gen)
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
    atol = {"postnet_mel": 1e-3, "wav": wav_atol}
    for k, tol in atol.items():
        if errs[k] > tol:
            raise AssertionError(f"{k} differs from the JAX golden by {errs[k]:.3e} > {tol}")
    say(phase, items=int(len(mel_lens)), mel_lens=mel_lens.tolist(),
        durations_exact=True, max_abs_err=errs, atol=atol, kernel_launches_per_call=per_call)
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


@functools.lru_cache(maxsize=None)
def icassp_acoustic(dev, seed: int = 0):
    """The ICASSP acoustic model (the `Config()` defaults = configs/icassp.yaml)
    with random weights from `seed` and one padded batch of 16 requests of 8
    characters from `seed`, on `dev`; built once per device and seed and
    shared by the phases (they run it in `.eval()` and change no weight)."""
    from visual_onoma_to_wave_tpu_torch.models import VTTS

    torch.manual_seed(seed)
    model = VTTS(n_vocab=64, n_audiotype=10, max_mel_len=MAX_MEL)
    # each character predicts ~FRAMES frames (exp(log d) - 1), as bench.py
    # biases its durations, so the decoder and vocoder see realistic lengths
    dur = model.variance_adaptor.duration_predictor.linear_layer
    with torch.no_grad():
        dur.weight.mul_(0.01)
        dur.bias.fill_(float(np.log(FRAMES + 1)))
    rng = np.random.default_rng(seed)
    batch = {
        "audiotypes": torch.from_numpy((np.arange(B) % 10).astype(np.int64)),
        "texts": torch.from_numpy(rng.integers(1, 64, (B, C)).astype(np.int64)),
        "src_lens": torch.full((B,), C, dtype=torch.int64),
        "image_cells": torch.from_numpy(rng.uniform(0, 1, (B, C, 24, 102)).astype(np.float32)),
    }
    return model.to(dev).eval(), {k: v.to(dev) for k, v in batch.items()}


def icassp_b16(dev, vocoder: str = "HiFi-GAN"):
    """`icassp_acoustic` and a vocoder at its published widths (HiFi-GAN V1,
    or Vocos: dim 512, intermediate 1536, 8 blocks), random weights from seed
    0. Returns (model, vocoder, batch) on `dev`; the acoustic model and batch
    do not depend on the vocoder."""
    from visual_onoma_to_wave_tpu_torch.models import get_vocoder

    model, batch = icassp_acoustic(torch.device(dev))
    torch.manual_seed(0)
    gen = get_vocoder(vocoder)
    for mod in gen.modules():
        if isinstance(mod, (torch.nn.Conv1d, torch.nn.ConvTranspose1d)):
            torch.nn.init.normal_(mod.weight, 0.0, 0.01)  # the reference's init
    return model, gen.to(dev).eval(), batch


def icassp_bf16(dev, vocoder: str = "HiFi-GAN"):
    """`icassp_b16`'s models with the same weights in bf16 compute (the
    acoustic model as `train.compute_dtype: bfloat16` builds it, the vocoder
    by `get_vocoder(vocoder, dtype=torch.bfloat16)`): (model, vocoder, batch)
    on `dev`, parameters fp32."""
    from visual_onoma_to_wave_tpu_torch.models import VTTS, get_vocoder

    model, gen, batch = icassp_b16(dev, vocoder)
    model16 = VTTS(n_vocab=64, n_audiotype=10, max_mel_len=MAX_MEL, dtype=torch.bfloat16)
    model16.load_state_dict(model.state_dict())
    gen16 = get_vocoder(vocoder, dtype=torch.bfloat16)
    gen16.load_state_dict(gen.state_dict())
    return model16.to(dev).eval(), gen16.to(dev).eval(), batch


def phase_full(dev, card: str, phase: str = "4 full width", vocoder: str = "HiFi-GAN",
               beside: dict | None = None) -> tuple[dict, tuple]:
    """Serve one padded ICASSP batch of 16 through the fused step with
    `vocoder` at full width; check each item's audio; time it. Returns the
    numbers and (vocoder module, outputs of the checked call)."""
    from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer

    torch.cuda.reset_peak_memory_stats()
    model, gen, batch = icassp_b16(dev, vocoder)
    fused = make_fused_infer(model, gen)
    per_call = per_call_launches(model, gen)
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
    mel = out["postnet_mel"]
    with torch.inference_mode():
        acoustic_ms = time_cuda(acoustic, 5, warmup=2)
        vocoder_ms = time_cuda(lambda: gen(mel), 5, warmup=2)
    fused_ms = time_cuda(lambda: fused(batch), 5, warmup=2)
    frames = int(mel_lens.sum())
    audio_s = frames * HOP / SR
    result = {"acoustic_ms": acoustic_ms, "vocoder_ms": vocoder_ms, "synthesis_ms": fused_ms,
              "acoustic_mel_frames_per_s": frames / (acoustic_ms / 1e3),
              "synthesis_x_realtime": audio_s / (fused_ms / 1e3),
              "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    extra = {}
    if beside is not None:
        extra["hifigan_v1"] = {k: beside[k] for k in ("acoustic_ms", "vocoder_ms", "synthesis_ms",
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
            "trunk_launches": trunk["convnext_trunk"], "served": served}


# Mel frontend (phase 7): the kernel against its plain version on the card,
# and the port against the JAX package on the CPU (tests/test_torch_stft.py).
# The kernel computes in float64 and rounds its outputs once; the plain
# version (and the JAX package) are fp32 spectra, whose rounding the final
# log amplifies in bins near the 1e-5 clamp and the log-power sum in bins of
# power near its 1e-8 eps. The bounds below are the fp32 side's error.
MEL_N_FFT, MEL_HOP, MAX_CHARS = 1024, 256, 48     # MAX_CHARS: the reference preprocessor's
MEL_ATOL = 1e-4
# full-scale clipping puts most bins of a frame 10 orders below its peak;
# there an fp32 FFT is 6.0e-4 off float64 in log-mel and the JAX kernel's
# DFT product 1.7e-3 (CPU, full_scale case), so that case, and the path over
# clips that include it, is held to the JAX package's own kernel-vs-jnp
# bound (tests/test_pallas_mel.py:157)
MEL_LOOSE = {"atol": 2e-3, "rtol": 1e-4}
MEL_MAE = 1e-3                      # the BASELINE.md gate, every case
SUM_RTOL = 1e-5                     # frame energy, power sum, char energy
# the log-power sum is held per bin (divided by n_freqs, i.e. the mean
# log-power that the kurtosis uses): full-scale frames differ by ~0.3 of
# ~-5000 in the sum, 6e-4 per bin (CPU, the port vs the JAX kernel)
LOG_POWER_PER_BIN_ATOL = 1e-3
KURT_ATOL, KURT_RTOL = 1e-4, 1e-4
# the kernel's log-mel against float64 (logmel_float64): the FFT, the split
# and each bin's power are float64, the rest fp32 (its rounding, ~1e-7
# relative on the magnitudes, and the fp32 output, 4.8e-7 at |log-mel| ~ 8)
MEL_FLOAT64_ATOL = 1e-5
# the n_fft sweep: every size the kernel takes, B 3, hop n_fft / 4, a clip of
# 5 frames (shorter than any block of the kernel) and one of three blocks
# and a ragged tail (ops/mel.py::block_frames), odd lengths so that every
# other item's rows are not 8-byte aligned
MEL_SWEEP_N_FFT = tuple(1 << e for e in range(4, 12))


def mel_sweep_cases() -> list[tuple[str, np.ndarray, int, int]]:
    """(name, clips (3, L) float32, n_fft, hop) of the sweep; the middle
    item is 60 dB quieter."""
    from visual_onoma_to_wave_tpu_torch.ops.mel import block_frames

    cases = []
    for n_fft in MEL_SWEEP_N_FFT:
        hop = n_fft // 4
        for kind, frames in (("short", 5), ("blocks", 3 * block_frames(n_fft) + 7)):
            x = np.random.default_rng(n_fft + frames).uniform(
                -1.1, 1.1, (3, n_fft + (frames - 1) * hop + 1)).astype(np.float32)
            x[1] *= 1e-3
            cases.append((f"n_fft{n_fft}_{kind}", x, n_fft, hop))
    return cases


def mel_frame_flops(n_fft: int, fb_nonzeros: int) -> tuple[float, float]:
    """Operations of the mel frontend per frame, counted for an FFT, as
    (float64, fp32): in float64 the window, a real FFT (2.5 n log2 n), each
    bin's power (3) and the power and log-power sums (2 a bin); in fp32 each
    bin's magnitude and log (2) and the mel product over the filterbank's
    nonzero weights."""
    bins = n_fft // 2 + 1
    return (n_fft + 2.5 * n_fft * np.log2(n_fft) + 5.0 * bins,
            2.0 * bins + 2.0 * fb_nonzeros)


def mel_cases() -> list[tuple[str, np.ndarray, int]]:
    """The parity grid of the mel frontend, the cases of
    tests/test_pallas_mel.py: (name, reflect-pre-padded clips (B, L) float32,
    win_length) at n_fft 1024, hop 256."""
    n_fft, hop = MEL_N_FFT, MEL_HOP

    def pre(a):
        return np.pad(a, ((0, 0), (n_fft // 2, n_fft // 2)), mode="reflect")

    L = 3 * hop * 13
    rng = np.random.default_rng(7)
    t = np.arange(L) / SR
    impulses = np.zeros(L, np.float32)
    impulses[::997] = 1.0
    adversarial = [
        ("near_silence", (1e-4 * rng.standard_normal(L)).astype(np.float32)),
        ("full_scale", np.clip(1.5 * np.sin(2 * np.pi * 120 * t), -1, 1).astype(np.float32)),
        ("impulse_train", impulses),
        ("true_zero", np.zeros(L, np.float32))]

    def uniform(seed, lo, shape):
        return np.random.default_rng(seed).uniform(lo, -lo, shape).astype(np.float32)

    return [("awkward_length", pre(uniform(0, -0.8, (2, 3 * hop * 17 + 5))), n_fft),
            ("odd_batch_short_clip", pre(uniform(1, -1.0, (3, 2048))), n_fft),
            ("long_700_hops", pre(uniform(3, -1.0, (1, hop * 700))), n_fft),
            ("win_800", pre(uniform(4, -1.0, (2, 4096))), 800),
            *[(name, pre(a[None]), n_fft) for name, a in adversarial],
            # frames end exactly on a 128-frame tile, the input 100 samples past it
            ("tile_boundary", uniform(1, -0.5, (1, n_fft + 127 * hop + 100)), n_fft)]


def mel_durations(batch: int, n_frames: int, max_chars: int = 8) -> np.ndarray:
    """Zero-padded durations over n_frames: even items 4 characters, one of
    them of 0 frames, the last frame left to no character; odd items one
    character over every frame."""
    d = np.zeros((batch, max_chars), np.int32)
    a, c = n_frames // 5, n_frames // 4
    d[0::2, :4] = [a, 0, c, n_frames - a - c - 1]
    d[1::2, 0] = n_frames
    return d


def _worst(err: np.ndarray) -> float:
    return float(err.max()) if err.size else 0.0


def check_mel_frontend(what: str, got, ref, loose: bool = False, n_fft: int = MEL_N_FFT) -> dict:
    """Hold mel_frontend outputs `got` = (logmel, energy, power_sum,
    log_power_sum), numpy, against `ref`; raise beyond the bounds above.
    Returns the errors."""
    lm, e, ps, lps = got
    rm, re_, rps, rlps = ref
    tol = MEL_LOOSE if loose else {"atol": MEL_ATOL, "rtol": 0.0}
    for name, a, b in (("logmel", lm, rm), ("energy", e, re_), ("power_sum", ps, rps),
                       ("log_power_sum", lps, rlps)):
        if a.shape != b.shape or not np.isfinite(a).all():
            raise AssertionError(f"{what}: {name} {a.shape} vs {b.shape}, "
                                 f"finite={bool(np.isfinite(a).all())}")
    mel_err = np.abs(lm - rm)
    errs = {"mel_max_abs": _worst(mel_err), "mel_mae": float(mel_err.mean()),
            "energy_rel": _worst(np.abs(e - re_) / np.maximum(re_, 1e-30) * (e != re_)),
            "power_sum_rel": _worst(np.abs(ps - rps) / np.maximum(rps, 1e-30) * (ps != rps)),
            "log_power_per_bin": _worst(np.abs(lps - rlps)) / (n_fft // 2 + 1)}
    if (mel_err > tol["atol"] + tol["rtol"] * np.abs(rm)).any() or errs["mel_mae"] >= MEL_MAE:
        raise AssertionError(f"{what}: logmel off by {errs['mel_max_abs']:.3e} "
                             f"(mae {errs['mel_mae']:.3e}); bound {tol}, mae < {MEL_MAE}")
    if max(errs["energy_rel"], errs["power_sum_rel"]) > SUM_RTOL:
        raise AssertionError(f"{what}: frame sums off by {errs} > {SUM_RTOL} relative")
    if errs["log_power_per_bin"] > LOG_POWER_PER_BIN_ATOL:
        raise AssertionError(f"{what}: log-power sum off by {errs['log_power_per_bin']:.3e} "
                             f"per bin > {LOG_POWER_PER_BIN_ATOL}")
    return errs


def kurtosis_mismatch(got: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Where kurtosis `got` disagrees with `ref`: beyond KURT_ATOL +
    KURT_RTOL |ref| where both are finite. A character whose frames are all
    exactly silent has gamma = 0 up to rounding and the estimator 0/0, whose
    limit is 1: there one side may be NaN, and the other must be NaN or
    within 1e-3 of 1."""
    both = np.isfinite(got) & np.isfinite(ref)
    near = np.abs(np.where(both, got - ref, 0.0)) > KURT_ATOL + KURT_RTOL * np.abs(
        np.where(both, ref, 0.0))
    other = np.where(np.isfinite(got), got, ref)
    degenerate = ~both & ~np.isnan(other) & ~(np.abs(other - 1.0) <= 1e-3)
    return near | degenerate


def _check_char_stats(what: str, ce, k, rce, rk) -> dict:
    errs = {"char_energy_rel": _worst(np.abs(ce - rce) / np.maximum(rce, 1e-30) * (ce != rce)),
            "kurtosis_max_abs": _worst(np.abs(np.nan_to_num(k - rk)))}
    if not np.isfinite(ce).all() or errs["char_energy_rel"] > SUM_RTOL:
        raise AssertionError(f"{what}: char energy off by {errs['char_energy_rel']:.3e} relative")
    bad = kurtosis_mismatch(k, rk)
    if bad.any():
        raise AssertionError(f"{what}: kurtosis {k[bad][:4]} vs {rk[bad][:4]} beyond "
                             f"{KURT_ATOL} + {KURT_RTOL} |ref|")
    return errs


def check_clip_features(what: str, got, ref, loose: bool = False) -> dict:
    """Hold (logmel, char_energy, kurtosis), numpy, against `ref` with the
    bounds above, logmel on every frame."""
    lm, ce, k = got
    rm, rce, rk = ref
    tol = MEL_LOOSE if loose else {"atol": MEL_ATOL, "rtol": 0.0}
    mel_err = np.abs(lm - rm)
    errs = {"mel_max_abs": _worst(mel_err), "mel_mae": float(mel_err.mean())}
    if not np.isfinite(lm).all() or (mel_err > tol["atol"] + tol["rtol"] * np.abs(rm)).any() \
            or errs["mel_mae"] >= MEL_MAE:
        raise AssertionError(f"{what}: logmel off by {errs['mel_max_abs']:.3e} "
                             f"(mae {errs['mel_mae']:.3e}); bound {tol}")
    return {**errs, **_check_char_stats(what, ce, k, rce, rk)}


def logmel_float64(x: torch.Tensor, n_fft: int = MEL_N_FFT, hop: int = MEL_HOP,
                   win_length: int | None = None) -> torch.Tensor:
    """The log-mel of pre-padded clips x (B, L) computed in float64, with
    the kernel's own fp32 window and filterbank: the arbiter of the kernel's
    log-mel."""
    from visual_onoma_to_wave_tpu_torch.ops import mel, stft

    window, _, _, _, fb = mel._host_constants(n_fft, win_length or n_fft, 80, SR, 0.0, 8000.0)
    mag = stft.framed_magnitude(x.double().clamp(-1.0, 1.0),
                                torch.from_numpy(window).double().to(x.device), n_fft, hop)
    return torch.log(torch.clamp(mag @ torch.from_numpy(fb).double().to(x.device),
                                 min=1.0e-5)).transpose(-1, -2)


def check_mel_float64(what: str, logmel: np.ndarray, exact: np.ndarray) -> float:
    """The kernel's log-mel against float64: within MEL_FLOAT64_ATOL (its
    fp32 output rounding and the fp32 stage after each bin's power)."""
    err = _worst(np.abs(logmel - exact))
    if not err <= MEL_FLOAT64_ATOL:
        raise AssertionError(f"{what}: logmel {err:.3e} off float64 > {MEL_FLOAT64_ATOL}")
    return err


def check_path_batch(what: str, got, plain, exact: np.ndarray) -> dict:
    """Pass 1 at real scale. Over real clips, tones at high amplitude leave
    many bins of a frame just above the 1e-5 clamp, where any fp32 spectrum
    is rounding noise: the plain fp32 version is up to 1.3e-2 off float64 in
    log-mel there (CPU, these 640 clips), beyond any bound the kernel could
    be held to against it. So the kernel's log-mel is held against float64
    (`exact`), within MEL_FLOAT64_ATOL (and so within MEL_LOOSE and MAE <
    MEL_MAE); char energy and kurtosis against the plain version."""
    lm, ce, k = got
    check_mel_float64(what, lm, exact)
    kernel_err, plain_err = np.abs(lm - exact), np.abs(plain[0] - exact)
    errs = {"mel_vs_float64_max": _worst(kernel_err),
            "mel_vs_float64_mae": float(kernel_err.mean()),
            "plain_mel_vs_float64_max": _worst(plain_err),
            "mel_vs_plain_max": _worst(np.abs(lm - plain[0]))}
    tol = MEL_LOOSE["atol"] + MEL_LOOSE["rtol"] * np.abs(exact)
    if not np.isfinite(lm).all() or errs["mel_vs_float64_mae"] >= MEL_MAE or \
            (kernel_err > tol).any():
        raise AssertionError(f"{what}: logmel vs float64 {errs}, bound {MEL_LOOSE}")
    return {**errs, **_check_char_stats(what, ce, k, plain[1], plain[2])}


def check_mel_sweep_case(dev, x: np.ndarray, n_fft: int, hop: int) -> dict:
    """The kernel at one case of the n_fft sweep against its plain version
    (check_mel_frontend's bounds) and against float64 (MEL_FLOAT64_ATOL)."""
    from visual_onoma_to_wave_tpu_torch.ops.mel import mel_frontend, mel_frontend_reference

    xt = torch.from_numpy(x).to(dev)
    got = _host(mel_frontend(xt, n_fft=n_fft, hop_length=hop, win_length=n_fft))
    ref = _host(mel_frontend_reference(xt, n_fft=n_fft, hop_length=hop, win_length=n_fft))
    what = f"mel n_fft {n_fft} hop {hop} {tuple(x.shape)}"
    errs = check_mel_frontend(what, got, ref, n_fft=n_fft)
    exact = logmel_float64(xt, n_fft, hop).cpu().numpy()
    return {**errs, "mel_vs_float64": check_mel_float64(what, got[0], exact)}


def parse_ptxas(log: str) -> dict[int, dict]:
    """Registers, stack and spills of each instantiation of the mel kernel
    in `nvcc -Xptxas -v` output, by n_fft."""
    import re

    report: dict[int, dict] = {}
    n_fft = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"mel_frontend_kernelILi(\d+)E", m.group(1))
            n_fft = 2 << int(k.group(1)) if k else None
            continue
        if n_fft is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report.setdefault(n_fft, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report.setdefault(n_fft, {})["registers"] = int(m.group(1))
    return report


def mel_ptxas_report() -> dict[int, dict]:
    """`parse_ptxas` of the built mel library's ptxas.log."""
    from visual_onoma_to_wave_tpu_torch.ops.cuda_build import library_path

    return parse_ptxas((library_path("mel_frontend").parent / "ptxas.log").read_text())


def feature_clips(n: int = 640, seed: int = 0) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """n clips of 0.3-6 s at 22 050 Hz and their per-character durations at
    hop 256, length-sorted as pass 1 sorts them. Clips are tones and noise
    bursts with silences between them; every 16th is one of the adversarial
    inputs (near silence, full-scale clipping, an impulse train, zeros).
    1-12 characters of positive duration cover all but 0-2 of a clip's
    len // 256 + 1 frames."""
    rng = np.random.default_rng(seed)
    clips, durs = [], []
    for i in range(n):
        L = int(rng.uniform(0.3, 6.0) * SR)
        t = np.arange(L) / SR
        kind = i % 64
        if kind == 0:
            a = 1e-4 * rng.standard_normal(L)
        elif kind == 16:
            a = np.clip(1.5 * np.sin(2 * np.pi * rng.uniform(80, 400) * t), -1, 1)
        elif kind == 32:
            a = np.zeros(L)
            a[::int(rng.integers(200, 2000))] = 1.0
        elif kind == 48:
            a = np.zeros(L)
        else:
            a = np.zeros(L)
            for _ in range(int(rng.integers(1, 6))):
                n_seg = int(rng.integers(L // 10, L // 2 + 2))
                s0 = int(rng.integers(0, L - n_seg + 1))
                env = np.hanning(n_seg) * rng.uniform(0.05, 0.9)
                if rng.random() < 0.6:
                    seg = np.sin(2 * np.pi * rng.uniform(80, 6000) * t[:n_seg])
                else:
                    seg = rng.standard_normal(n_seg) * 0.5
                a[s0:s0 + n_seg] += env * seg
        frames = L // MEL_HOP + 1
        total = frames - int(rng.integers(0, 3))
        n_chars = int(rng.integers(1, 13))
        cuts = np.sort(rng.choice(np.arange(1, total), n_chars - 1, replace=False))
        clips.append(a.astype(np.float32))
        durs.append(np.diff(np.concatenate([[0], cuts, [total]])).astype(np.int32))
    order = np.argsort([len(a) for a in clips], kind="stable")
    return [clips[i] for i in order], [durs[i] for i in order]


@functools.lru_cache(maxsize=4)
def _window_and_fb(win_length: int, device: torch.device):
    from visual_onoma_to_wave_tpu_torch.ops import stft

    return (torch.from_numpy(stft.hann_window(win_length)).to(device),
            torch.from_numpy(stft.melscale_fbanks(MEL_N_FFT // 2 + 1, 0.0, 8000.0, 80,
                                                  SR)).to(device))


def plain_clip_features(x: torch.Tensor, d: torch.Tensor, max_chars: int,
                        win_length: int = MEL_N_FFT):
    """`fused_clip_features`'s plain form: ops/stft.py::clip_features with the
    window and filterbank on x's device."""
    from visual_onoma_to_wave_tpu_torch.ops import stft

    window, fb = _window_and_fb(win_length, x.device)
    return stft.clip_features(x, d, window, fb, max_chars, MEL_N_FFT, MEL_HOP, win_length)


def _host(tensors) -> list[np.ndarray]:
    return [t.cpu().numpy() for t in tensors]


def phase_mel(dev, card: str) -> dict:
    from visual_onoma_to_wave_tpu_torch.data.features import extract_features, pad_batch
    from visual_onoma_to_wave_tpu_torch.ops.mel import (
        fused_clip_features, mel_frontend, mel_frontend_reference)

    phase = "7 mel frontend"
    worst: dict[str, float] = {}

    def keep(errs: dict, prefix: str) -> None:
        for k, v in errs.items():
            worst[f"{prefix}{k}"] = max(worst.get(f"{prefix}{k}", 0.0), v)

    cases = mel_cases()
    for name, x, win in cases:
        xt = torch.from_numpy(x).to(dev)
        got = _host(mel_frontend(xt, win_length=win))
        ref = _host(mel_frontend_reference(xt, win_length=win))
        loose = name == "full_scale"
        keep(check_mel_frontend(f"{phase} {name}", got, ref, loose), "")
        keep({"mel_vs_float64": check_mel_float64(
            f"{phase} {name}", got[0], logmel_float64(xt, win_length=win).cpu().numpy())}, "")
        d = torch.from_numpy(mel_durations(x.shape[0], got[1].shape[-1])).to(dev)
        keep(check_clip_features(f"{phase} clip_features {name}",
                                 _host(fused_clip_features(xt, d, 8, win_length=win)),
                                 _host(plain_clip_features(xt, d, 8, win)), loose), "clip_")
    sweep = {name: check_mel_sweep_case(dev, x, n_fft, hop)
             for name, x, n_fft, hop in mel_sweep_cases()}
    torch.cuda.synchronize()
    say(phase + " parity", card=card, cases=[c[0] for c in cases], max_err=worst,
        bounds={"mel_atol": MEL_ATOL, "mel_full_scale": MEL_LOOSE, "mel_mae": MEL_MAE,
                "mel_vs_float64": MEL_FLOAT64_ATOL, "sums_rel": SUM_RTOL,
                "log_power_per_bin": LOG_POWER_PER_BIN_ATOL,
                "kurtosis": [KURT_ATOL, KURT_RTOL]})
    say(phase + " n_fft sweep", card=card, max_err=sweep)
    spills = mel_ptxas_report()
    say(phase + " ptxas", card=card, instances=spills)
    spilled = {n: r for n, r in spills.items() if r["spill_stores"] or r["spill_loads"]}
    if len(spills) != len(MEL_SWEEP_N_FFT) or spilled:
        raise AssertionError(f"{phase}: ptxas instances {sorted(spills)}, spilling {spilled}")

    # pass 1 at real scale: 640 clips in length-sorted 64-clip batches
    clips, durs = feature_clips()
    batches = [(clips[i:i + 64], durs[i:i + 64]) for i in range(0, len(clips), 64)]
    frames = sum(int(d.sum()) for d in durs)
    zero_launch_counts()
    outs = [_host(extract_features(a, d, device=dev, max_chars=MAX_CHARS)) for a, d in batches]
    torch.cuda.synchronize()
    launches = launch_counts()
    expect_launches(phase, launches, {"mel_frontend": len(batches)})
    path_err: dict[str, float] = {}
    for (a, d), out in zip(batches, outs):
        batch, dur = pad_batch(a, d, n_fft=MEL_N_FFT, hop_length=MEL_HOP, max_chars=MAX_CHARS)
        x = torch.from_numpy(batch).to(dev)
        plain = _host(plain_clip_features(x, torch.from_numpy(dur).to(dev), MAX_CHARS))
        if out[0].shape != (len(a), 80, (batch.shape[1] - MEL_N_FFT) // MEL_HOP + 1):
            raise AssertionError(f"{phase}: logmel {out[0].shape} for a batch {batch.shape}")
        errs = check_path_batch(f"{phase} path", out, plain, logmel_float64(x).cpu().numpy())
        for k, v in errs.items():
            path_err[k] = max(path_err.get(k, 0.0), v)

    def stage(kernel: bool):
        def run():
            for a, d in batches:
                if kernel:
                    _host(extract_features(a, d, device=dev, max_chars=MAX_CHARS))
                else:
                    batch, dur = pad_batch(a, d, n_fft=MEL_N_FFT, hop_length=MEL_HOP,
                                           max_chars=MAX_CHARS)
                    _host(plain_clip_features(torch.from_numpy(batch).to(dev),
                                              torch.from_numpy(dur).to(dev), MAX_CHARS))
        return run

    stage_ms = {"kernel": [], "plain": []}
    for order in (("kernel", "plain"), ("plain", "kernel")):
        for k in order:
            stage_ms[k].append(time_cuda(stage(k == "kernel"), 1, warmup=1))
    per_stage = {k: float(np.mean(v)) for k, v in stage_ms.items()}

    # device time at one 64-clip batch of the largest bucket
    batch, dur = pad_batch(*batches[-1], n_fft=MEL_N_FFT, hop_length=MEL_HOP,
                           max_chars=MAX_CHARS)
    x, d = torch.from_numpy(batch).to(dev), torch.from_numpy(dur).to(dev)
    window, fb = _window_and_fb(MEL_N_FFT, dev)

    window64, fb64 = window.double(), fb.double()

    def library():
        """torch.stft and the mel product (cuFFT, cuBLAS) in fp32: the log-mel alone."""
        spec = torch.stft(x, MEL_N_FFT, MEL_HOP, window=window, center=False,
                          return_complex=True)
        return torch.log(torch.clamp(fb.t() @ spec.abs(), min=1.0e-5))

    def library_fp64():
        """The kernel's function in float64 (cuFFT, cuBLAS): the clipped
        audio's log-mel and the three frame sums."""
        spec = torch.stft(x.double().clamp(-1.0, 1.0), MEL_N_FFT, MEL_HOP, window=window64,
                          center=False, return_complex=True).abs()
        power = spec * spec
        p_sum = power.sum(-2)
        return (torch.log(torch.clamp(fb64.t() @ spec, min=1.0e-5)), torch.sqrt(p_sum), p_sum,
                torch.log(power + 1.0e-8).sum(-2))

    runs = {"mel_frontend": lambda: mel_frontend(x),
            "mel_frontend_plain": lambda: mel_frontend_reference(x),
            "mel_frontend_library": library,
            "mel_frontend_library_fp64": library_fp64,
            "clip_features": lambda: fused_clip_features(x, d, MAX_CHARS),
            "clip_features_plain": lambda: plain_clip_features(x, d, MAX_CHARS)}
    exact = logmel_float64(x)
    lib_err = float((library() - mel_frontend_reference(x)[0]).abs().max().item())
    vs_float64 = {"kernel": float((mel_frontend(x)[0] - exact).abs().max().item()),
                  "library_fp32": float((library() - exact).abs().max().item()),
                  "library_fp64": float((library_fp64()[0] - exact).abs().max().item())}
    times = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):
        for k in order:
            times[k].append(time_cuda(runs[k], 10, warmup=2))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    outs = mel_frontend(x)
    n_frames = x.shape[0] * outs[0].shape[-1]
    flops64, flops32 = (n_frames * f for f in mel_frame_flops(MEL_N_FFT,
                                                              int((fb != 0).sum().item())))
    moved = nbytes(x, *outs)
    # float64 operations at the float64 rate and fp32 ones at the fp32 rate;
    # beside it every operation at the fp32 rate (the bound before the
    # kernel's float64 was counted)
    b = bound(flops64 + flops32 * PEAK_FP64_FLOPS / PEAK_FP32_FLOPS, moved, PEAK_FP64_FLOPS)
    b32 = bound(flops64 + flops32, moved, PEAK_FP32_FLOPS)
    say(phase + " path", card=card, clips=len(clips), batches=len(batches),
        frames=frames, kernel_launches=launches, max_err_vs_plain=path_err,
        stage_ms=per_stage, stage_ms_runs=stage_ms,
        clips_per_s={k: len(clips) / (v / 1e3) for k, v in per_stage.items()},
        frames_per_s={k: frames / (v / 1e3) for k, v in per_stage.items()},
        shape_timed=f"B=64 L={batch.shape[1]} n_fft={MEL_N_FFT} hop={MEL_HOP} 80 mels",
        ms=ms, ms_runs=times, **b, bound_fp32_rate_ms=b32["bound_ms"],
        share_of_bound=b["bound_ms"] / ms["mel_frontend"],
        share_of_fp32_rate_bound=b32["bound_ms"] / ms["mel_frontend"],
        flops_float64=flops64, flops_fp32=flops32, bytes=moved,
        library_logmel_vs_plain=lib_err, logmel_vs_float64=vs_float64)
    return {"launches": launches["mel_frontend"],
            "max_abs_err": worst["mel_max_abs"],
            "ms": ms["mel_frontend"], "plain_ms": ms["mel_frontend_plain"], **b,
            "library_ms": ms["mel_frontend_library"],
            "library_fp64_ms": ms["mel_frontend_library_fp64"],
            "bound_fp32_rate_ms": b32["bound_ms"], "logmel_vs_float64": vs_float64,
            "n_fft_sweep_mel_vs_float64": max(v["mel_vs_float64"] for v in sweep.values()),
            "ptxas": spills}


# Fused MRF stage (phase 8). fp32: the kernel (3xTF32, a fresh tensor-core
# sum per 16 input channels of a tap) and cuDNN sum the 18 convs in other
# orders, 1e-5 x max |plain| (measured ~2e-7 relative); bf16 rounds every
# conv input to bf16 in both, where an order difference can flip a rounding
# that the later convs carry: 2e-2 x max |plain| (~5 bf16 steps)
MRF_OF_SCALE = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# every width the kernel takes: the ICASSP generators' and the demo HiFi-GAN's
# (upsample_initial_channel 128: stages at 64 / 32 / 16 / 8)
MRF_WIDTHS = (8, 16, 32, 64, 128, 256, 512)
# served stage shapes (C, T) at B 16, ICASSP max_mel_len 1000
MRF_SHAPES = {"istftnet_melrate": (512, 1000), "c8c8i_1 / hifigan_1": (256, 8000),
              "c8c8i_2 / hifigan_2": (128, 64000), "hifigan_3": (64, 128000),
              "hifigan_4": (32, 256000)}


def mrf_parity_t(C: int) -> tuple[int, ...]:
    """T of the parity cases at width C: shorter than the stage's 60-frame
    halo, around the conv chain's time tile and, where they are built,
    around the one-pass kernel's and the unit design's frame tiles, and the
    served max_mel_len."""
    from visual_onoma_to_wave_tpu_torch.ops.mrf import (
        ONEPASS_KERNEL_WIDTHS, UNIT_KERNEL_WIDTHS, onepass_tile_frames, tile_frames,
        unit_tile_frames)

    tiles = [tile_frames(C)] + \
        ([onepass_tile_frames(C)] if C in ONEPASS_KERNEL_WIDTHS else []) + \
        ([unit_tile_frames(C)] if C in UNIT_KERNEL_WIDTHS else [])
    return tuple(sorted({20, MAX_MEL, *(t + i for t in tiles for i in (-1, 0, 1))}))


def mrf_weights(C: int, gen, dev, dtype=torch.float32):
    """Packed stage weights (k 3/7/11) at a scale that keeps every residual
    stream O(1), so that errors show."""
    mats = [(torch.randn(6, C, k * C, generator=gen, device=dev) * (0.5 / (k * C) ** 0.5)
             ).to(dtype) for k in (3, 7, 11)]
    return mats, torch.randn(18, C, 1, generator=gen, device=dev) * 0.1


def mrf_cost(x: torch.Tensor, mats, bias) -> tuple[float, int]:
    """(FLOPs, bytes) of a stage: 6 * (3 + 7 + 11) * C^2 multiply-adds per
    position; x read, the output written, the weights read once."""
    B_, C_, T_ = x.shape
    return 252.0 * C_ * C_ * B_ * T_, nbytes(x, x, *mats, bias)


def mrf_design_bytes(B_: int, C_: int, T_: int, dtype) -> dict:
    """What the conv chain's structure moves a stage (csrc/mrf.cu's header):
    device memory, in fp32 planes of (B, T, C) (x^T written; per conv its
    input read once per tile with the tile's halo, its output written,
    conv2's residual read; the three y read and the output written by the
    average), and the weight stream from L2 (every tile reads its conv's taps
    once)."""
    from visual_onoma_to_wave_tpu_torch.ops.mrf import tile_frames

    tile, plane = tile_frames(C_), B_ * T_ * C_ * 4
    size = torch.empty((), dtype=dtype).element_size()
    split = 2 if dtype == torch.float32 else 1
    tiles = B_ * -(-T_ // tile)
    planes, weights = 1.0, 0.0
    for k in (3, 7, 11):
        for d in (1, 3, 5):
            for pad in ((k - 1) // 2 * d, (k - 1) // 2):
                planes += 2 + 2 * pad / tile
            planes += 1   # conv2's residual
            weights += 2 * tiles * k * C_ * C_ * size * split
    dram = planes * plane + 3 * plane + 2 * B_ * T_ * C_ * size
    return {"dram_bytes": dram, "dram_planes": dram / plane, "l2_weight_bytes": weights,
            "dram_ms_at_peak": dram / PEAK_BYTES_PER_S * 1e3}


def mrf_onepass_design(B_: int, C_: int, T_: int) -> dict:
    """What the one-pass kernel's structure moves and computes a stage
    (csrc/mrf.cu): device memory x (bf16) read once and the output written
    once, the weights once; from L2 the window of x three times a tile (once
    per branch) and all 126 C^2 bf16 weights a tile; on the tensor cores the
    64-row tiles each conv computes, halo included (the kernel's `ext`)."""
    from visual_onoma_to_wave_tpu_torch.ops.mrf import onepass_tile_frames

    m_out = onepass_tile_frames(C_)
    tiles = B_ * -(-T_ // m_out)
    rows = 0            # rows x taps the tensor cores take a tile, all branches
    for k in (3, 7, 11):
        p, reach, ext = (k - 1) // 2, 0, [0] * 6
        for i in (2, 1, 0):
            ext[2 * i + 1] = reach
            reach += p
            ext[2 * i] = reach
            reach += p * (1, 3, 5)[i]
        for e in ext:
            rows += 64 * (m_out // 64 + -(-2 * e // 64)) * k
    ops = 2.0 * tiles * rows * C_ * C_
    dram = 2 * 2 * B_ * T_ * C_ + 126 * C_ * C_ * 2
    return {"tile_frames": m_out, "dram_bytes": dram,
            "dram_ms_at_peak": dram / PEAK_BYTES_PER_S * 1e3,
            "l2_x_bytes": 3 * tiles * (m_out + 128) * C_ * 2,
            "l2_weight_bytes": tiles * 126 * C_ * C_ * 2,
            "tensor_ops_with_halo": ops, "halo_factor": ops / (252.0 * C_ * C_ * B_ * T_),
            "tensor_ms_at_peak": ops / PEAK_BF16_FLOPS * 1e3}


def mrf_unit_design(B_: int, C_: int, T_: int) -> dict:
    """What the unit design's structure moves and computes a stage
    (csrc/mrf.cu, "one launch per residual unit"): device memory, in fp32
    planes of (B, T, C), x (bf16) read once, each unit's three residual
    streams written and read by the next, the average's reads and the output;
    from L2 each tile's X window (its frames and 64 more on each side, fp32)
    and conv2's residual, and per pass all of a conv's taps for the pass's
    channels; on the tensor cores the 64-row tiles each pass computes (a
    warpgroup's idle tiles not counted)."""
    from visual_onoma_to_wave_tpu_torch.ops.mrf import unit_tile_frames

    m = unit_tile_frames(C_)
    n1, n2 = m // 64 + 1, m // 64
    nt, mb, cols = (128, 1, False) if C_ == 128 else (64, 2, C_ == 256)
    ns = min(C_, 128)
    rows_a_pass = mb * (1 if cols else 2)                 # 64-row tiles a pass
    tiles = B_ * -(-T_ // m)
    plane = B_ * T_ * C_ * 4
    dram = 0.5 * plane + 3 * 3 * plane + 2 * 3 * plane + 3 * plane + 0.5 * plane
    passes = (C_ // ns) * (-(-n1 // rows_a_pass) + -(-n2 // rows_a_pass))
    weights = 3 * tiles * sum(passes * (C_ // 32) * k * ns * 32 * 2 for k in (3, 7, 11))
    rows = (n1 + n2) * 64                                 # rows both convs compute a tile
    ops = 2.0 * 3 * tiles * rows * C_ * C_ * 21
    return {"tile_frames": m, "dram_bytes": dram, "dram_planes": dram / plane,
            "dram_ms_at_peak": dram / PEAK_BYTES_PER_S * 1e3,
            "l2_window_bytes": 3 * 3 * tiles * (m + 128) * C_ * 4,
            "l2_weight_bytes": weights, "passes_a_unit": passes, "wgmma_n": nt,
            "tensor_ops_with_halo": ops, "halo_factor": ops / (252.0 * C_ * C_ * B_ * T_),
            "tensor_ms_at_peak": ops / PEAK_BF16_FLOPS * 1e3}


def mrf_library_bf16(mats, bias, dev):
    """The bf16 cuDNN chain `MRFStages` runs on `ResBlock1` modules in bf16
    (JAX hifigan.py:36-67: every conv output rounded to bf16, the residual
    sums in bf16), built from the packed stage weights: a callable on x."""
    from visual_onoma_to_wave_tpu_torch.models.hifigan import ResBlock1

    C = mats[0].shape[1]
    blocks = []
    with torch.no_grad():
        for b, (a, k) in enumerate(zip(mats, (3, 7, 11))):
            block = ResBlock1(C, k, (1, 3, 5), dtype=torch.bfloat16).to(dev).eval()
            w = a.float().reshape(6, C, k, C).permute(0, 1, 3, 2)
            for i, conv in enumerate(c for pair in zip(block.convs1, block.convs2) for c in pair):
                conv.weight.copy_(w[i])
                conv.bias.copy_(bias[6 * b + i, :, 0])
            blocks.append(block)

    def run(x):
        x = x.to(torch.bfloat16)
        return (blocks[0](x) + blocks[1](x) + blocks[2](x)) / 3

    return run


def mrf_ptxas_report() -> dict:
    """Registers, stack and spills of each one-pass instantiation
    (`mrf_onepass_kernel<C, TPW>`) and each unit-design instantiation
    (`mrf_unit_kernel<C>`) in the built MRF library's ptxas.log."""
    import re

    from visual_onoma_to_wave_tpu_torch.ops.cuda_build import library_path

    report, key = {"onepass": {}, "unit": {}}, None
    for line in (library_path("mrf").parent / "ptxas.log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"mrf_(onepass|unit)_kernelILi(\d+)E", m.group(1))
            key = (k.group(1), f"C{k.group(2)}") if k else None
            continue
        if key is None:
            continue
        entry = report[key[0]].setdefault(key[1], {})
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                         spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    return report


def phase_mrf(dev, card: str) -> dict:
    from visual_onoma_to_wave_tpu_torch.ops.mrf import (
        UNIT_KERNEL_WIDTHS, _mrf_stage_chain, mrf_route, mrf_stage_fused,
        mrf_stage_fused_reference, mrf_stage_onepass, mrf_stage_unit, onepass_takes,
        pack_mrf_kernel_weights, sm_count, unit_takes)

    phase = "8 mrf"
    ptxas = mrf_ptxas_report()
    say(phase + " ptxas", card=card, **ptxas)
    sms = sm_count(dev)
    ks, ds = (3, 7, 11), ((1, 3, 5),) * 3
    gen = torch.Generator(device=dev).manual_seed(8)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}    # of max |plain|
    worst_by_width = {}                                  # bf16 routed, of max |plain|
    worst_abs = 0.0                                      # fp32, absolute
    # bf16, each tile design on every case it is built for: of max |plain|
    # by width, and its largest absolute gap to the chain
    design_err = {"onepass": {}, "unit": {}}
    design_vs_chain = {"onepass": 0.0, "unit": 0.0}
    cases = 0
    for C in MRF_WIDTHS:
        mats, bias = mrf_weights(C, gen, dev)
        for T in mrf_parity_t(C):
            for Bc in (1, 4):
                x = torch.randn(Bc, C, T, generator=gen, device=dev)
                for dtype in (torch.float32, torch.bfloat16):
                    before = launch_counts()
                    out = mrf_stage_fused(x, *mats, bias, dtype=dtype)
                    route = mrf_route(C, dtype, ks, ds, Bc, T, sms)
                    expect_launches(f"{phase} route B={Bc} C={C} T={T} {dtype}", launch_counts(),
                                    {k: n + (k == MRF_RECORD[route]) for k, n in before.items()})
                    ref = mrf_stage_fused_reference(x, *mats, bias, dtype=dtype)
                    torch.cuda.synchronize()
                    scale = ref.float().abs().max().item()
                    err = (out.float() - ref.float()).abs().max().item()
                    if out.shape != ref.shape or out.dtype != ref.dtype or \
                            not bool(torch.isfinite(out.float()).all()) or \
                            err > MRF_OF_SCALE[dtype] * scale:
                        raise AssertionError(f"{phase}: kernel != plain at B={Bc} C={C} T={T} "
                                             f"{dtype}: {err:.3e} of max {scale:.3e}")
                    worst[dtype] = max(worst[dtype], err / scale)
                    if dtype == torch.float32:
                        worst_abs = max(worst_abs, err)
                        cases += 1
                        continue
                    worst_by_width[C] = max(worst_by_width.get(C, 0.0), err / scale)
                    # every bf16 design built for the stage, on the same
                    # operands and under the same bound; the tile designs sum
                    # in the chain's grouping and order (csrc/mrf.cu)
                    xb, pk, bf = (x.to(dtype).contiguous(), pack_mrf_kernel_weights(mats, dtype),
                                  bias.float().contiguous())
                    chain = _mrf_stage_chain(xb, pk, bf, ks, ds).float()
                    for design, takes, run in (("onepass", onepass_takes, mrf_stage_onepass),
                                               ("unit", unit_takes, mrf_stage_unit)):
                        if not takes(C, dtype):
                            continue
                        got = run(xb, pk, bf).float()
                        derr = (got - ref.float()).abs().max().item()
                        if not bool(torch.isfinite(got).all()) or \
                                derr > MRF_OF_SCALE[dtype] * scale:
                            raise AssertionError(f"{phase}: {design} design != plain at B={Bc} "
                                                 f"C={C} T={T}: {derr:.3e} of max {scale:.3e}")
                        design_err[design][C] = max(design_err[design].get(C, 0.0),
                                                    derr / scale)
                        design_vs_chain[design] = max(design_vs_chain[design],
                                                      (got - chain).abs().max().item())
                    cases += 1
    say(phase + " parity", card=card, cases=cases, widths=MRF_WIDTHS,
        T={C: mrf_parity_t(C) for C in MRF_WIDTHS}, batch=(1, 4), max_abs_err_fp32=worst_abs,
        max_err_of_max_abs={str(d).split(".")[-1]: v for d, v in worst.items()},
        bf16_max_err_of_max_abs_by_width=worst_by_width,
        onepass_max_err_of_max_abs_by_width=design_err["onepass"],
        unit_max_err_of_max_abs_by_width=design_err["unit"],
        routes_bf16_served_size={C: mrf_route(C, torch.bfloat16) for C in MRF_WIDTHS},
        onepass_vs_chain_max_abs=design_vs_chain["onepass"],
        unit_vs_chain_max_abs=design_vs_chain["unit"],
        bound_of_max_abs={str(d).split(".")[-1]: v for d, v in MRF_OF_SCALE.items()})

    shapes = {}
    with torch.inference_mode():
        for name, (C, T) in MRF_SHAPES.items():
            mats, bias = mrf_weights(C, gen, dev)
            x = torch.randn(B, C, T, generator=gen, device=dev)
            # the weights packed once, as the served generators keep them
            packed = {d: pack_mrf_kernel_weights(mats, d) for d in (torch.float32, torch.bfloat16)}
            library_bf16 = mrf_library_bf16(mats, bias, dev)
            route = mrf_route(C, torch.bfloat16, ks, ds, B, T, sms)
            runs = {"kernel": lambda: mrf_stage_fused(x, *mats, bias,
                                                      packed=packed[torch.float32]),
                    "plain": lambda: mrf_stage_fused_reference(x, *mats, bias),
                    "kernel_bf16": lambda: mrf_stage_fused(x, *mats, bias, dtype=torch.bfloat16,
                                                           packed=packed[torch.bfloat16]),
                    "plain_bf16": lambda: mrf_stage_fused_reference(x, *mats, bias,
                                                                    dtype=torch.bfloat16),
                    "library_bf16": lambda: library_bf16(x)}
            # each bf16 design the route did not take, where it is built, on
            # the same operands (x rounded to bf16 inside each call, as
            # `kernel_bf16` does)
            bf = bias.float().contiguous()
            others = {"chain_bf16": (True, _mrf_stage_chain),
                      "onepass_bf16": (onepass_takes(C, torch.bfloat16), mrf_stage_onepass),
                      "unit_bf16": (unit_takes(C, torch.bfloat16), mrf_stage_unit)}
            for other, (built, fn) in others.items():
                if built and other != f"{route}_bf16":
                    runs[other] = functools.partial(
                        lambda fn: fn(x.to(torch.bfloat16), packed[torch.bfloat16], bf, ks, ds), fn)
            ref = runs["plain"]()
            abs_err = (runs["kernel"]() - ref).abs().max().item()
            err = abs_err / ref.abs().max().item()
            del ref
            ref16 = runs["plain_bf16"]().float()
            got16 = runs["kernel_bf16"]().float()
            bf16_abs = (got16 - ref16).abs().max().item()
            bf16_err = bf16_abs / ref16.abs().max().item()
            chain16 = got16 if route == "chain" else runs["chain_bf16"]().float()
            vs_chain = {o: (runs[o]().float() - chain16).abs().max().item()
                        for o in ("onepass_bf16", "unit_bf16") if o in runs}
            vs_chain[f"{route}_bf16"] = (got16 - chain16).abs().max().item()
            del ref16, got16, chain16
            if err > MRF_OF_SCALE[torch.float32] or bf16_err > MRF_OF_SCALE[torch.bfloat16]:
                raise AssertionError(f"{phase}: kernel != plain at B={B} C={C} T={T}: fp32 "
                                     f"{err:.3e}, bf16 {bf16_err:.3e} of max |plain|")
            worst_abs = max(worst_abs, abs_err)
            times = {n: [] for n in runs}
            for order in (list(runs), list(runs)[::-1]):
                for n in order:
                    times[n].append(time_cuda(runs[n], 2, warmup=1))
            ms = {n: float(np.mean(t)) for n, t in times.items()}
            # each bf16 design's own time under its name
            ms[f"{route}_bf16"] = ms["kernel_bf16"]
            flops, moved = mrf_cost(x, mats, bias)
            bounds = {"fp32_cuda_cores": bound(flops, moved),
                      "tensor_cores_3xtf32": bound(3 * flops, moved, PEAK_TF32_FLOPS),
                      "tensor_cores_bf16": bound(flops, moved / 2, PEAK_BF16_FLOPS)}
            design = {"fp32": mrf_design_bytes(B, C, T, torch.float32),
                      "bf16": mrf_design_bytes(B, C, T, torch.bfloat16)}
            if onepass_takes(C, torch.bfloat16):
                design["bf16_onepass"] = mrf_onepass_design(B, C, T)
            if unit_takes(C, torch.bfloat16):
                design["bf16_unit"] = mrf_unit_design(B, C, T)
            shapes[name] = {
                "C": C, "T": T, "ms": ms, "ms_runs": times, "bounds": bounds,
                "bf16_design": route,
                "bf16_launches_a_stage": {"onepass": 1, "unit": 4, "chain": 8}[route],
                "kernel_tflops": flops / (ms["kernel"] * 1e9),
                "plain_tflops": flops / (ms["plain"] * 1e9),
                "kernel_share_of_cuda_core_bound":
                    bounds["fp32_cuda_cores"]["bound_ms"] / ms["kernel"],
                "kernel_share_of_3xtf32_bound":
                    bounds["tensor_cores_3xtf32"]["bound_ms"] / ms["kernel"],
                "plain_share_of_cuda_core_bound":
                    bounds["fp32_cuda_cores"]["bound_ms"] / ms["plain"],
                "kernel_bf16_share_of_bf16_bound":
                    bounds["tensor_cores_bf16"]["bound_ms"] / ms["kernel_bf16"],
                "kernel_vs_library": ms["plain"] / ms["kernel"],
                "kernel_bf16_vs_library_bf16": ms["library_bf16"] / ms["kernel_bf16"],
                "err_of_max_abs": {"fp32": err, "bf16": bf16_err},
                "bf16_max_abs_err": bf16_abs, "bf16_designs_vs_chain_max_abs": vs_chain,
                "design": design}
            del x, packed, library_bf16
            torch.cuda.empty_cache()
    say(phase + " times", card=card, batch=B, dtype="fp32 (*_bf16: bf16)",
        library="the plain version (cuDNN F.conv1d chain, TF32 off); library_bf16: the "
                "ResBlock1 modules in bf16", shapes=shapes)
    melrate, served = shapes["istftnet_melrate"], shapes["hifigan_4"]
    unit = shapes["hifigan_3"]
    return {"max_abs_err": worst_abs, "ms": melrate["ms"]["kernel"],
            "plain_ms": melrate["ms"]["plain"],
            **melrate["bounds"]["tensor_cores_3xtf32"],
            "bound_fp32_cuda_cores_ms": melrate["bounds"]["fp32_cuda_cores"]["bound_ms"],
            "library_ms": melrate["ms"]["plain"],
            "bf16": {"max_abs_err_of_max_abs": worst[torch.bfloat16],
                     "ms": melrate["ms"]["kernel_bf16"],
                     "library_bf16_ms": melrate["ms"]["library_bf16"],
                     **melrate["bounds"]["tensor_cores_bf16"]},
            "onepass": {"shape": {"C": served["C"], "T": served["T"], "B": B},
                        "max_abs_err": served["bf16_max_abs_err"],
                        "max_err_of_max_abs": {f"C{c}": v
                                               for c, v in design_err["onepass"].items()},
                        "ms": served["ms"]["onepass_bf16"], "plain_ms": served["ms"]["plain_bf16"],
                        **served["bounds"]["tensor_cores_bf16"],
                        "library_ms": served["ms"]["library_bf16"],
                        "chain_ms": served["ms"]["chain_bf16"],
                        "ptxas": ptxas["onepass"],
                        "c64_not_routed": {"ms": unit["ms"]["onepass_bf16"],
                                           "chain_ms": unit["ms"]["chain_bf16"]}},
            "unit": {"shape": {"C": unit["C"], "T": unit["T"], "B": B},
                     "max_abs_err": (unit["bf16_max_abs_err"] if unit["bf16_design"] == "unit"
                                     else None),
                     "max_err_of_max_abs": {f"C{c}": v for c, v in design_err["unit"].items()},
                     "vs_chain_max_abs": design_vs_chain["unit"],
                     "ms": unit["ms"]["unit_bf16"], "plain_ms": unit["ms"]["plain_bf16"],
                     **unit["bounds"]["tensor_cores_bf16"],
                     "library_ms": unit["ms"]["library_bf16"],
                     "chain_ms": unit["ms"]["chain_bf16"], "ptxas": ptxas["unit"],
                     "by_width": {f"C{sh['C']}": {"ms": sh["ms"]["unit_bf16"],
                                                   "chain_ms": sh["ms"]["chain_bf16"],
                                                   "routed": sh["bf16_design"] == "unit",
                                                   **sh["bounds"]["tensor_cores_bf16"]}
                                  for sh in shapes.values() if sh["C"] in UNIT_KERNEL_WIDTHS}}}


def phase_served(dev, card: str) -> dict:
    """The port's own HTTP server over the demo iSTFTNet-mel Synthesizer on
    `dev`: 4 concurrent /v1/synthesize requests, each must answer 200 with
    mel_frames * 256 samples of audio; every batch the server ran launched
    the attention kernel per FFT block and the MRF kernel once."""
    import base64
    import http.client
    import io
    import threading
    import wave

    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.serve import BatchingServer
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    phase = "12 served"
    cfg = load_config(DEMO / "config_istftnet.json")
    cfg = cfg.replace(path=cfg.path.__class__(
        corpus="", formatted="", preprocessed=str(DEMO / "preprocessed"), font="",
        ckpt="", log="", result=""))
    synth = Synthesizer.from_checkpoint(cfg, str(DEMO / "torch" / "acoustic.npz"),
                                        str(DEMO / "torch" / "vocoder_istftnet_mel.npz"),
                                        device=dev)
    requests = [{"text": "バウバウ", "audiotype": "bell"},
                {"text": "チパチパチパ", "audiotype": "drum"},
                {"text": "パシウドパシウド", "audiotype": "bell", "e_control": 1.2},
                {"text": "シトパリ", "audiotype": "drum", "d_control": 1.5}]
    srv = BatchingServer(synth, port=0, max_batch=8, batch_window_ms=50.0)
    srv.warmup()
    srv.reset_stats()
    answers = [None] * len(requests)

    def post(i):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        try:
            conn.request("POST", "/v1/synthesize", json.dumps(requests[i]),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            answers[i] = (resp.status, json.loads(resp.read()))
        finally:
            conn.close()

    zero_launch_counts()
    srv.start()
    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        stats = srv.snapshot_stats()
    finally:
        srv.stop()
    launches = launch_counts()
    samples = []
    for req, ans in zip(requests, answers):
        if ans is None or ans[0] != 200:
            raise AssertionError(f"{phase}: {req} answered {ans}")
        r = ans[1]
        with wave.open(io.BytesIO(base64.b64decode(r["wav_b64"])), "rb") as w:
            n, pcm = w.getnframes(), np.frombuffer(w.readframes(w.getnframes()), "<i2")
        if len(r["durations"]) != len(req["text"]) or n != r["mel_frames"] * HOP or not pcm.any():
            raise AssertionError(f"{phase}: {req} gave {n} samples for {r['mel_frames']} frames")
        samples.append(n)
    if dev.type == "cuda":
        per_batch = per_call_launches(synth.model, synth.vocoder)
        expect_launches(phase, launches,
                        {k: v * stats["batches"] for k, v in per_batch.items()})
    say(phase, card=card, requests=len(requests), answered_200=len(samples), samples=samples,
        batches=stats["batches"], mean_batch_size=stats["mean_batch_size"],
        latency_ms_p50=stats.get("latency_ms_p50"), kernel_launches=launches)
    return {"launches": launches, "stats": stats}


# phase 13: the synthetic corpus, the model and the training cadence
TRAIN_CLIPS_PER_CLASS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_WARMUP = 24, 200, 16, 40
FIRST_STEP_RTOL = 1e-4


def train_config(work: pathlib.Path, raw_root_ono: pathlib.Path):
    """The port's `Config` of phase 13's run on the corpus under `work`
    (the ICASSP model; no model block)."""
    from visual_onoma_to_wave_tpu_torch.config import config_from_dict
    from visual_onoma_to_wave_tpu_torch.data.synthetic_corpus import work_config

    cfg = work_config(work, raw_root_ono, TRAIN_STEPS)
    cfg["train"]["optimizer"].update(batch_size=TRAIN_BATCH, warm_up_step=TRAIN_WARMUP)
    cfg["train"]["step"].update(total_step=TRAIN_STEPS, log_step=20, val_step=100,
                                val_metrics=True, save_step=100, synth_step=10 ** 9)
    return config_from_dict(cfg)


def first_step_parity(trainer, dev) -> dict:
    """One train step of the trainer's initial model, every dropout rate 0,
    on `dev` and on the CPU, on the first batch of epoch 1: the loss terms
    and grad norm agree within FIRST_STEP_RTOL (relative)."""
    import copy

    from visual_onoma_to_wave_tpu_torch.data.dataset import to_device
    from visual_onoma_to_wave_tpu_torch.models.layers import Dropout
    from visual_onoma_to_wave_tpu_torch.training.schedule import NoamAdam
    from visual_onoma_to_wave_tpu_torch.training.train_state import TrainState, train_step

    batch = next(trainer.train_ds.batches(group_size=4, seed=trainer.config.train.seed + 1))
    opt = trainer.config.train.optimizer
    out = {}
    for where in (dev, torch.device("cpu")):
        model = copy.deepcopy(trainer.state.model).to(where)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        optimizer = NoamAdam(model.parameters(), init_lr=opt.init_lr,
                             warmup_steps=opt.warm_up_step, grad_clip=opt.grad_clip_thresh)
        state = TrainState(model, optimizer, torch.Generator(device=where).manual_seed(0))
        losses = train_step(state, to_device(batch, where))
        out[where.type] = {k: float(v) for k, v in losses.items()}
        del model, optimizer, state
    rel = {k: abs(out[dev.type][k] - v) / max(abs(v), 1e-12) for k, v in out["cpu"].items()}
    if max(rel.values()) > FIRST_STEP_RTOL:
        raise AssertionError(f"first train step on {dev} vs the CPU: relative errors {rel}")
    return {"card": out[dev.type], "cpu": out["cpu"], "max_rel_err": max(rel.values())}


def phase_train(dev, card: str, work: pathlib.Path) -> dict:
    """The port's corpus pipeline and acoustic trainer on `dev` (see the
    module docstring, phase 13), under `work`, which keeps the corpus
    (preprocessed with its audio) and the checkpoints for phase 17."""
    from visual_onoma_to_wave_tpu_torch.data.formatting import format_dataset
    from visual_onoma_to_wave_tpu_torch.data.labels import prepare_textgrids
    from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor
    from visual_onoma_to_wave_tpu_torch.data.synthetic_corpus import build_corpus
    from visual_onoma_to_wave_tpu_torch.ops.attention import attention_core
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer
    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer

    phase = "13 acoustic training"
    raw_root, ono_root = build_corpus(work, TRAIN_CLIPS_PER_CLASS)
    cfg = train_config(work, ono_root)
    format_dataset(cfg, raw_root)
    prepare_textgrids(cfg.path.formatted, list(cfg.dataset.extract_labels))
    zero_launch_counts()
    Preprocessor(cfg, device=dev, save_audio=True).build(verbose=False)
    corpus_launches = launch_counts()
    expect_launches(phase + " preprocess", corpus_launches,
                    {"mel_frontend": max(corpus_launches["mel_frontend"], 1)})

    trainer = Trainer(cfg, device=dev)
    first = first_step_parity(trainer, dev)
    every = (cfg.train.step.val_step, cfg.train.step.save_step)
    marks, frames, losses, seen = [], [], [], [0]
    b1 = {"train": 0, "evaluate": 0}

    def on_step(step, step_losses):
        """Called by the trainer after each step and its evaluate and save:
        one CUDA event per step, the step's frames and losses, and the
        attention launches since the last call, charged to the train steps
        or, at a val step, to evaluate."""
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
        marks.append((step, mark))
        frames.append(trainer.timer.frames[-1])
        losses.append(step_losses)
        launched, seen[0] = attention_core.launches - seen[0], attention_core.launches
        b1["evaluate" if step % every[0] == 0 else "train"] += launched

    torch.cuda.reset_peak_memory_stats(dev)
    zero_launch_counts()
    trainer.train(on_step=on_step)
    torch.cuda.synchronize(dev)
    train_launches = launch_counts()
    n_val = trainer.state.step // every[0]
    before = attention_core.launches
    trainer.evaluate(metrics=True)
    per_evaluate = attention_core.launches - before
    # a period that ends at a val or save step holds that evaluate or save
    timed = [i for i in range(1, len(marks))
             if all(marks[i][0] % e for e in every)]
    step_ms = np.array([marks[i - 1][1].elapsed_time(marks[i][1]) for i in timed])
    frames = np.array([int(frames[i]) for i in timed])
    table = {k: np.array([float(x[k]) for x in losses]) for k in losses[0]}
    if not all(np.isfinite(v).all() for v in table.values()):
        raise AssertionError(f"{phase}: a loss or grad norm is not finite")
    total = table["total_loss"]
    if not total[-20:].mean() < total[:20].mean():
        raise AssertionError(f"{phase}: total loss did not fall: first 20 "
                             f"{total[:20].mean()}, last 20 {total[-20:].mean()}")
    # the val steps' count is their evaluates' alone: none in their train steps
    if b1["train"] != 0 or per_evaluate == 0 or b1["evaluate"] != n_val * per_evaluate:
        raise AssertionError(f"{phase}: attention kernel launches {b1} with {per_evaluate} "
                             f"per evaluate: expected none in the train steps")
    expect_launches(phase + " train", train_launches, {"flash_mha": b1["evaluate"]})
    say(phase, card=card, params=trainer.n_params(), clips=len(trainer.train_ds),
        steps=trainer.state.step, corpus_kernel_launches=corpus_launches,
        first_step=first, step_ms_median=float(np.median(step_ms)),
        step_ms_mean=float(step_ms.mean()),
        mel_frames_per_s=float(frames.sum() / (step_ms.sum() / 1e3)),
        peak_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        loss_first20=float(total[:20].mean()), loss_last20=float(total[-20:].mean()),
        grad_norm_max=float(table["grad_norm"].max()), flash_mha_launches=b1,
        val=[json.loads(line) for line in
             (pathlib.Path(cfg.path.log) / "val" / "metrics.jsonl").read_text().splitlines()])

    saved = {k: v.detach().cpu().clone() for k, v in trainer.state.model.state_dict().items()}
    resumed = Trainer(cfg, restore_step=-1, device=dev)
    restored = resumed.state.model.state_dict()
    same = all(torch.equal(saved[k], restored[k].cpu()) for k in saved
               if not k.endswith("num_batches_tracked"))
    if not same or resumed.state.step != TRAIN_STEPS:
        raise AssertionError(f"{phase}: restore at step {resumed.state.step} is not the "
                             "saved state")
    resumed.train(max_steps=TRAIN_STEPS + 1)
    if resumed.state.step != TRAIN_STEPS + 1:
        raise AssertionError(f"{phase}: the resumed trainer is at {resumed.state.step}")

    synth = Synthesizer.from_checkpoint(
        cfg, str(pathlib.Path(cfg.path.ckpt) / str(TRAIN_STEPS) / "acoustic.npz"),
        device=dev)
    zero_launch_counts()
    result = synth.synthesize("パンドン", "drum")
    synth_launches = launch_counts()
    if not (np.isfinite(result.mel).all() and result.mel.shape[1] == 80
            and synth_launches["flash_mha"] > 0):
        raise AssertionError(f"{phase}: synthesis from the checkpoint gave mel "
                             f"{result.mel.shape} with launches {synth_launches}")
    expect_launches(phase + " synthesis", synth_launches,
                    {"flash_mha": synth_launches["flash_mha"]})
    say(phase, resumed_step=resumed.state.step, restored_bit_exact=same,
        synth_mel_frames=int(result.mel.shape[0]), synth_kernel_launches=synth_launches)
    return {"step_ms": float(np.median(step_ms)), "cfg": cfg}



# phases 14-15: the vocoder surface. Card against CPU (the same BigVGAN
# module), chunked against full forward (the interior, a halo from each true
# edge) and the chunked kernel path against the same windows through the
# plain path on the card (the kernels' fp32 is 3xTF32) differ in summation
# order only: held to 1e-4 absolute and to 1e-4 of the reference's max
# |sample| (BigVGAN's waveforms at random weights of scale 0.01 are O(1e-3),
# where 1e-4 absolute alone would hold nothing)
VOCODE_ATOL = 1e-4
CHUNK_FRAMES, CHUNK_B = 256, 4


def check_vocode(what: str, err: float, scale: float) -> None:
    if not (err <= VOCODE_ATOL and err <= VOCODE_ATOL * scale):
        raise AssertionError(f"{what}: max error {err:.3e} at max |reference| {scale:.3e} "
                             f"(bounds {VOCODE_ATOL} absolute and of the max)")


@contextlib.contextmanager
def plain_on_card(gen):
    """While the context lasts, `gen`'s MRF stages run as their ResBlock1
    modules (cuDNN convs) and its ConvNeXt blocks as
    `convnext_block_reference`, on the card: the plain path its kernels are
    held against."""
    import visual_onoma_to_wave_tpu_torch.models.vocos as vocos
    from visual_onoma_to_wave_tpu_torch.ops.convnext import convnext_block_reference

    def plain_stage(i, blocks, x, fused=True):
        acc = None
        for block in blocks:
            y = block(x)
            acc = y if acc is None else acc + y
        return acc / len(blocks)

    def plain_block(x, *weights, packed=None, **kw):
        return convnext_block_reference(x, *weights, **kw)

    mrf, block = getattr(gen, "_mrf", None), vocos.convnext_block
    if mrf is not None:
        gen._mrf = plain_stage
    vocos.convnext_block = plain_block
    try:
        yield
    finally:
        if mrf is not None:
            gen._mrf = mrf
        vocos.convnext_block = block


def aa_fir_times(gen, mel: torch.Tensor) -> dict:
    """Device time of the anti-aliasing FIRs in one BigVGAN forward on `mel`,
    from one `torch.profiler` pass: each `upsample2` / `downsample2` call is
    wrapped in a `record_function` range, and its kernels' device time under
    the ranges is held against all kernels' device time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    import visual_onoma_to_wave_tpu_torch.models.bigvgan as bv

    originals = {"upsample2": bv.upsample2, "downsample2": bv.downsample2}
    calls = [0]

    def annotated(fn):
        def run(x, w):
            calls[0] += 1
            with record_function("aa_fir"):
                return fn(x, w)
        return run

    def kernel_us(evt) -> float:
        return (sum(k.duration for k in evt.kernels)
                + sum(kernel_us(c) for c in evt.cpu_children))

    for name, fn in originals.items():
        setattr(bv, name, annotated(fn))
    try:
        with torch.inference_mode():
            gen(mel)
            torch.cuda.synchronize()
            calls[0] = 0
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                gen(mel)
                torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(bv, name, fn)
    events = prof.events()
    total_us = sum(k.duration for e in events for k in e.kernels)
    fir_us = sum(kernel_us(e) for e in events if e.name == "aa_fir")
    return {"fir_calls": calls[0], "profiler_kernel_ms": total_us / 1e3,
            "profiler_fir_ms": fir_us / 1e3,
            "profiler_fir_share": fir_us / total_us if total_us else None}


def check_card_vs_cpu(phase: str, gen, mel: torch.Tensor) -> dict:
    """The module on the card against a copy of it on the CPU, same input."""
    import copy

    with torch.inference_mode():
        card = gen(mel).cpu()
        ref = copy.deepcopy(gen).cpu()(mel.cpu())
    err = float((card - ref).abs().max())
    scale = float(ref.abs().max())
    check_vocode(f"{phase}: card vs CPU", err, scale)
    return {"shape": list(mel.shape), "max_abs_err": err, "max_abs_cpu": scale}


def phase_bigvgan(dev, card: str, hifigan: dict) -> dict:
    """BigVGAN base at ICASSP B16 through the fused step (phase 4 with the
    vocoder swapped), the same weights without anti-aliasing for the AA's
    share of the vocoder ms, the AA FIRs' share from a profiler pass, the
    card against the CPU at B 2 x T 64; then the large preset at B16."""
    import time

    from visual_onoma_to_wave_tpu_torch.models import get_vocoder

    phase = "14 bigvgan full width"
    served, (gen, out) = phase_full(dev, card, phase, "BigVGAN", beside=hifigan)
    mel = out["postnet_mel"]
    plain = get_vocoder("BigVGAN", anti_aliased=False)
    plain.load_state_dict(gen.state_dict())
    plain = plain.to(dev).eval()
    runs = {"anti_aliased": lambda: gen(mel), "no_anti_aliasing": lambda: plain(mel)}
    times = {k: [] for k in runs}
    with torch.inference_mode():
        for order in (("anti_aliased", "no_anti_aliasing"), ("no_anti_aliasing", "anti_aliased")):
            for k in order:
                times[k].append(time_cuda(runs[k], 3, warmup=1))
    aa_ms, plain_ms = (float(np.mean(times[k])) for k in runs)
    fir = aa_fir_times(gen, mel)
    g = torch.Generator().manual_seed(0)
    small = (torch.randn(2, 64, 80, generator=g) - 4.0).to(dev)
    cpu = check_card_vs_cpu(phase, gen, small)
    say(phase + " anti-aliasing", card=card, vocoder_ms=aa_ms,
        vocoder_ms_without_aa=plain_ms, aa_share=1.0 - plain_ms / aa_ms, runs=times,
        **fir, card_vs_cpu=cpu,
        atol=VOCODE_ATOL)
    t0 = time.perf_counter()
    large, (large_gen, _) = phase_full(dev, card, "14 bigvgan-large full width", "BigVGAN-large",
                                       beside=hifigan)
    large_cpu = check_card_vs_cpu("14 bigvgan-large", large_gen,
                                  (torch.randn(1, 16, 80, generator=g) - 4.0).to(dev))
    say("14 bigvgan-large card vs cpu", card=card, card_vs_cpu=large_cpu, atol=VOCODE_ATOL,
        phase_s=time.perf_counter() - t0)
    return {"base": served, "large": large, "aa_share": 1.0 - plain_ms / aa_ms}


def phase_chunked(dev, card: str, mel: torch.Tensor) -> dict:
    """`vocoder_infer_chunked` on the card for HiFi-GAN V1, iSTFTNet-mel,
    Vocos and BigVGAN base at their published widths (phase 4's first
    CHUNK_B mels, T 1000, chunk CHUNK_FRAMES): one forward over every window,
    with its MRF / ConvNeXt kernel launches counted, the interior within
    VOCODE_ATOL (absolute and of the max) of the full forward. Then `Synthesizer.vocode` on the demo
    HiFi-GAN checkpoint fed the golden requests' mels cut to their lengths:
    mel_len x hop finite samples each, within VOCODE_ATOL of the fused path's
    waveform away from its last halo x hop samples (past them the two see
    different padding: zeros to the 64-frame bucket against the acoustic
    model's own padded frames)."""
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.models.hifigan import (
        generator_halo_frames,
        vocoder_infer_chunked,
    )
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer, make_fused_infer

    phase = "15 chunked and vocode"
    mel = mel[:CHUNK_B].contiguous()
    result = {}
    for family in ("HiFi-GAN", "iSTFTNet-mel", "Vocos", "BigVGAN"):
        _, gen, _ = icassp_b16(dev, family)
        halo = generator_halo_frames(gen)
        n_windows = CHUNK_B * -(-mel.shape[1] // CHUNK_FRAMES)
        want = {**mrf_stages(gen), "convnext_block": convnext_blocks(gen)}
        zero_launch_counts()
        wav = vocoder_infer_chunked(gen, mel, chunk_frames=CHUNK_FRAMES)
        torch.cuda.synchronize()
        launches = launch_counts()
        expect_launches(f"{phase} {family}", launches, want)
        with torch.inference_mode():
            full = gen(mel)
        h = halo * HOP
        if tuple(wav.shape) != tuple(full.shape) or not bool(torch.isfinite(wav).all()):
            raise AssertionError(f"{phase} {family}: chunked {tuple(wav.shape)} vs full "
                                 f"{tuple(full.shape)}, finite={bool(torch.isfinite(wav).all())}")
        err = float((wav[:, h:-h] - full[:, h:-h]).abs().max())
        check_vocode(f"{phase} {family}: chunked interior vs the full forward", err,
                     float(full[:, h:-h].abs().max()))
        plain_err = None      # BigVGAN runs no kernel: its path is the plain one
        if any(want.values()):
            zero_launch_counts()
            with plain_on_card(gen):
                plain = vocoder_infer_chunked(gen, mel, chunk_frames=CHUNK_FRAMES)
            torch.cuda.synchronize()
            expect_launches(f"{phase} {family} plain", launch_counts(), {})
            plain_err = float((wav - plain).abs().max())
            check_vocode(f"{phase} {family}: chunked through the kernels vs the plain path",
                         plain_err, float(plain.abs().max()))
        with torch.inference_mode():
            chunked_ms = time_cuda(lambda: vocoder_infer_chunked(gen, mel, CHUNK_FRAMES), 3, 1)
            full_ms = time_cuda(lambda: gen(mel), 3, 1)
        result[family] = {"halo_frames": halo, "windows": n_windows,
                          "window_frames": CHUNK_FRAMES + 2 * halo,
                          "kernel_launches": {k: launches[k] for k in want},
                          "interior_max_abs_err": err, "max_abs_err_vs_plain": plain_err,
                          "max_abs_full": float(full.abs().max()),
                          "chunked_ms": chunked_ms, "full_ms": full_ms}
        say(f"{phase} {family}", card=card, batch=CHUNK_B, frames=int(mel.shape[1]),
            chunk_frames=CHUNK_FRAMES, atol=VOCODE_ATOL, **result[family])

    cfg = load_config(DEMO / "config.json")
    cfg = cfg.replace(path=cfg.path.__class__(
        corpus="", formatted="", preprocessed=str(DEMO / "preprocessed"), font="",
        ckpt="", log="", result=""))
    synth = Synthesizer.from_checkpoint(cfg, str(DEMO / "torch" / "acoustic.npz"),
                                        str(DEMO / "torch" / "vocoder.npz"), device=dev)
    g = dict(np.load(DEMO / "torch" / "golden.npz"))
    out = make_fused_infer(synth.model, synth.vocoder)(
        {k: torch.from_numpy(g[k]).to(dev)
         for k in ("audiotypes", "texts", "src_lens", "image_cells")},
        **{k: torch.from_numpy(g[k]).to(dev) for k in ("e_control", "d_control")})
    lens = out["mel_lens"].cpu().numpy().astype(int)
    postnet = out["postnet_mel"].cpu().numpy()
    cut = np.zeros((len(lens), int(lens.max()), postnet.shape[-1]), np.float32)
    for i, n in enumerate(lens):
        cut[i, :n] = postnet[i, :n]
    zero_launch_counts()
    wavs = synth.vocode(cut, lens)
    expect_launches(phase + " vocode", launch_counts(), mrf_stages(synth.vocoder))
    fused = out["wav"].cpu().numpy()
    halo = generator_halo_frames(synth.vocoder)
    errs = []
    for i, (w, n) in enumerate(zip(wavs, lens)):
        if w.shape != (n * HOP,) or not np.isfinite(w).all():
            raise AssertionError(f"{phase} vocode: item {i} has {w.shape} samples for "
                                 f"mel_len {n}, finite={np.isfinite(w).all()}")
        m = (n - halo) * HOP
        errs.append(float(np.abs(w[:m] - fused[i, :m]).max()))
    if max(errs) > VOCODE_ATOL:
        raise AssertionError(f"{phase} vocode: differs from the fused path by {max(errs):.3e}")
    say(phase + " vocode", card=card, mel_lens=lens.tolist(), mel_bucket=synth.mel_bucket,
        halo_frames=halo, max_abs_err_vs_fused=errs, atol=VOCODE_ATOL)
    result["synthesize-batch"] = check_synthesize_batch(card, cfg, synth)
    return result


# synthesize-batch rows (phase 15): both row formats, a name to sanitise,
# per-row controls; two batches at --batch-size 4
BATCH_ROWS = ("clip/a b|bell|24||バウバウ\n"
              "チパチパチパ\tdrum\t1.0\t1.2\n"
              "パシウドパシウド\tbell\t0.8\n"
              "シトパリ\tdrum\n"
              "パン\tbell\t1.3\t0.9\n")


def check_synthesize_batch(card: str, cfg, synth) -> dict:
    """`cli synthesize-batch` on the card (its default device) with the demo
    HiFi-GAN checkpoint, under a temporary directory: one file per row, each
    of mel_len x hop samples, within one 16-bit step of what
    `Synthesizer.synthesize_batch` (`synth`, the same checkpoint) gives for
    the same batches, its kernels launched once per batch."""
    import io
    import tempfile
    import wave

    from visual_onoma_to_wave_tpu_torch import cli
    from visual_onoma_to_wave_tpu_torch.data.audio_io import wav_bytes

    phase = "15 chunked and vocode synthesize-batch"
    e_ctl, d_ctl, batch_size = 1.1, 0.9, 4

    def pcm(data: bytes) -> np.ndarray:
        with wave.open(io.BytesIO(data)) as w:
            return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.int32)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_batch_") as tmp:
        tmp = pathlib.Path(tmp)
        raw = json.loads((DEMO / "config.json").read_text())
        raw["path"]["preprocessed"] = str(DEMO / "preprocessed")
        (tmp / "config.json").write_text(json.dumps(raw))
        (tmp / "rows.txt").write_text(BATCH_ROWS, encoding="utf-8")
        rows = cli._read_batch_rows(tmp / "rows.txt")
        batches = -(-len(rows) // batch_size)
        zero_launch_counts()
        rc = cli.main(["synthesize-batch", str(tmp / "config.json"), str(tmp / "rows.txt"),
                       str(tmp / "out"), "--acoustic", str(DEMO / "torch" / "acoustic.npz"),
                       "--vocoder", str(DEMO / "torch" / "vocoder.npz"),
                       "--batch-size", str(batch_size), "--e-control", str(e_ctl),
                       "--d-control", str(d_ctl)])
        torch.cuda.synchronize()
        launches = launch_counts()
        per_call = per_call_launches(synth.model, synth.vocoder)
        expect_launches(phase, launches, {k: n * batches for k, n in per_call.items()})
        files = {p.name: p.read_bytes() for p in (tmp / "out").iterdir()}
    order = sorted(range(len(rows)), key=lambda i: len(rows[i]["text"]))
    hop, sr = cfg.audio.stft.hop_length, cfg.audio.sampling_rate
    checked = {}
    for c0 in range(0, len(order), batch_size):
        chunk = [rows[i] for i in order[c0:c0 + batch_size]]
        results = synth.synthesize_batch(
            [r["text"] for r in chunk], [r["audiotype"] for r in chunk],
            e_control=[r["e"] * e_ctl for r in chunk],
            d_control=[r["d"] * d_ctl for r in chunk], return_mel=False)
        for r, res in zip(chunk, results):
            name = "".join(ch if ch.isalnum() or ch in "-_." else "_" for ch in r["name"])
            if f"{name}.wav" not in files:
                raise AssertionError(f"{phase}: no {name}.wav among {sorted(files)}")
            got = pcm(files[f"{name}.wav"])
            if got.shape != (res.mel_len * hop,):
                raise AssertionError(f"{phase}: {name}.wav has {got.shape} samples for "
                                     f"mel_len {res.mel_len}")
            steps = int(np.abs(got - pcm(wav_bytes(res.wav, sr))).max())
            if steps > 1:
                raise AssertionError(f"{phase}: {name}.wav differs from synthesize_batch by "
                                     f"{steps} 16-bit steps")
            checked[name] = {"mel_len": res.mel_len, "max_pcm16_steps": steps}
    if rc != 0 or sorted(files) != sorted(f"{n}.wav" for n in checked):
        raise AssertionError(f"{phase}: exit {rc}, files {sorted(files)}, rows {sorted(checked)}")
    say(phase, card=card, rows=len(rows), batches=batches, kernel_launches=launches,
        files=checked)
    return checked


# phase 16: the demo quality gate (BASELINE.md's demo row) through the
# port's tool on the card against the same tool on the CPU in this run: B3
# feeds the corpus with a float64 FFT, and B1 / B2 / B4 multiply in 3xTF32
# where the CPU runs IEEE fp32. Every gate number is held to 1e-4 relative:
# the card's differ from the CPU's by at most 1.42e-6 (NVIDIA H100 80GB
# HBM3, 700 W), and a fault in some tiles or frames that moves a mean over 3
# to 6 items by less would still show in the direct check of one vocoded
# waveform against the CPU's (VOCODE_ATOL). The CPU's equal the reference
# tool's within 1e-3 (tests/test_torch_quality_gate.py).
GATE_RTOL = 1e-4
GATE_KEYS = {"acoustic": ("mel_l1", "mcd", "mcd_dtw"), "vocoder": ("mel_l1", "mcd_db", "mrstft")}
DEMO_REQUESTS = ({"text": "パンパン", "audiotype": "drum", "width_rates": [1.0, 0.5, 1.5, 0.5]},
                 {"text": "カンコン", "audiotype": "bell"},
                 {"text": "ドンドン", "audiotype": "drum", "d_control": 1.3, "e_control": 0.8},
                 {"text": "チリリン", "audiotype": "bell", "width_rates": [2.0, 1.0, 1.0, 1.0]})


def gate_tool():
    """`tools/eval_quality_demo_torch.py` as a module."""
    sys.path.insert(0, str(ROOT / "tools"))
    import eval_quality_demo_torch

    return eval_quality_demo_torch


def phase_quality_gate(dev, card: str) -> dict:
    """The gate's three paths on the card, each with its launches counted:
    the corpus build (B3), the acoustic model's `evaluate(metrics=True)` (B1)
    and each committed vocoder's copy-synthesis (B2 for HiFi-GAN and
    iSTFTNet-mel, B4 for Vocos); then the whole gate on the CPU, and every
    gate number of the card within GATE_RTOL of the CPU's. The launches are
    worked out from the inputs: one B3 per batch of BATCH_CLIPS clips of a
    label, two passes of every FFT block's B1 per val batch (teacher-forced
    and free-running), one B2 per MRF stage and one B4 per ConvNeXt block
    per clip. Each vocoder's waveform of the first clip is also held to the
    same generator's on the CPU within VOCODE_ATOL."""
    import tempfile
    import time

    from visual_onoma_to_wave_tpu_torch.config import config_from_dict
    from visual_onoma_to_wave_tpu_torch.data.dataset import OnomaDataset
    from visual_onoma_to_wave_tpu_torch.data.preprocess import BATCH_CLIPS
    from visual_onoma_to_wave_tpu_torch.models.vocoder import vocoder_infer

    gate = gate_tool()
    phase = "16 quality gate"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gate_") as tmp:
        work = pathlib.Path(tmp)
        t0 = time.perf_counter()
        zero_launch_counts()
        cfg_dict = gate.build_gate_corpus(work / "card", str(dev))
        corpus = launch_counts()
        cfg = config_from_dict(cfg_dict)
        # pass 1's clips: --save-audio writes one waveform each (the
        # augmented copies of pass 3 have mels but no waveform)
        clips = [len(list(d.glob("*.npy")))
                 for d in sorted((work / "card" / "preprocessed" / "audio").iterdir())]
        expect_launches(phase + " corpus", corpus,
                        {"mel_frontend": sum(-(-n // BATCH_CLIPS) for n in clips)})
        zero_launch_counts()
        card_means = gate.acoustic_quality(cfg_dict, DEMO / "torch" / "acoustic.npz", str(dev))
        evaluate = launch_counts()
        val_batches = len(OnomaDataset("val.txt", cfg).batch_plan(1, shuffle=False))
        blocks = cfg.model.transformer.encoder_layer + cfg.model.transformer.decoder_layer
        expect_launches(phase + " evaluate", evaluate, {"flash_mha": 2 * blocks * val_batches})
        logmel = gate.make_logmel(cfg.audio, str(dev))
        gt = gate.ground_truth(work / "card" / "preprocessed", cfg.audio.stft.hop_length, logmel)
        card_means["vocoders"], vocoder_launches = {}, {}
        wav_errs = {}
        for (tag, family, gen), (_, _, cpu_gen) in zip(gate.committed_vocoders(),
                                                       gate.committed_vocoders()):
            zero_launch_counts()
            score = gate.make_scorer(gen, gt, logmel, str(dev))()
            vocoder_launches[tag] = launch_counts()
            expect_launches(f"{phase} {tag}", vocoder_launches[tag],
                            {**{k: n * len(gt) for k, n in mrf_stages(gen).items()},
                             "convnext_block": convnext_blocks(gen) * len(gt)})
            card_means["vocoders"][tag] = {"family": family, "clips": len(gt), **score}
            mel = torch.from_numpy(np.ascontiguousarray(gt[0][1].T))[None]
            with torch.no_grad():
                got = vocoder_infer(gen, mel.to(dev))[0].cpu()
                want = vocoder_infer(cpu_gen.eval(), mel)[0]
            scale = float(want.abs().max())
            wav_errs[tag] = {"max_abs_err": float((got - want).abs().max()),
                             "max_abs_cpu": scale}
            check_vocode(f"{phase} {tag} waveform card vs cpu", wav_errs[tag]["max_abs_err"],
                         scale)
        gate.assert_finite(card_means)
        card_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_means = gate.run_gate(work / "cpu", "cpu")
        cpu_s = time.perf_counter() - t0
    rel = {k: abs(card_means[k] - cpu_means[k]) / abs(cpu_means[k])
           for k in GATE_KEYS["acoustic"]}
    for tag, scores in cpu_means["vocoders"].items():
        rel.update({f"{tag}.{k}": abs(card_means["vocoders"][tag][k] - scores[k]) / abs(scores[k])
                    for k in GATE_KEYS["vocoder"]})
    worst = max(rel.values())
    if worst > GATE_RTOL:
        raise AssertionError(f"{phase}: card against CPU, relative errors {rel}")
    say(phase, card=card, gate_card=card_means, gate_cpu=cpu_means, max_rel_err=worst,
        rtol=GATE_RTOL, corpus_kernel_launches=corpus, evaluate_kernel_launches=evaluate,
        vocoder_kernel_launches=vocoder_launches, waveform_card_vs_cpu=wav_errs,
        wav_atol=VOCODE_ATOL, card_s=card_s, cpu_s=cpu_s)
    return {"card": card_means, "cpu": cpu_means}


def phase_demo_server(dev, card: str) -> dict:
    """The port's `DemoServer` over the demo checkpoint (HiFi-GAN) on the
    card: after one untimed cold request, four /api/synthesize requests in
    turn, each 200 with a wav of mel_frames x 256 samples, the rendered
    strip and the mel figure as PNGs; every request launches B1 per FFT
    block and B2 per MRF stage."""
    import base64
    import http.client
    import io
    import time
    import wave

    from PIL import Image

    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.demo_server import DemoServer
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer
    from visual_onoma_to_wave_tpu_torch.utils.plotting import FIG_WIDTH, PANEL_HEIGHT

    phase = "16 demo server"
    cfg = load_config(DEMO / "config.json")
    cfg = cfg.replace(path=cfg.path.__class__(
        corpus="", formatted="", preprocessed=str(DEMO / "preprocessed"), font="",
        ckpt="", log="", result=""))
    synth = Synthesizer.from_checkpoint(cfg, str(DEMO / "torch" / "acoustic.npz"),
                                        str(DEMO / "torch" / "vocoder.npz"), device=dev)
    srv = DemoServer(synth, port=0)

    def post(req: dict) -> tuple[int, dict, float]:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        t0 = time.perf_counter()
        try:
            conn.request("POST", "/api/synthesize", json.dumps(req),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
        finally:
            conn.close()
        ms = (time.perf_counter() - t0) * 1e3
        return resp.status, (json.loads(body) if resp.status == 200 else body.decode()), ms

    srv.start()
    try:
        status, cold, _ = post(DEMO_REQUESTS[0])     # builds and autotunes: not timed
        if status != 200:
            raise AssertionError(f"{phase}: the cold request answered {status}: {cold}")
        zero_launch_counts()
        answers = [post(req) for req in DEMO_REQUESTS]
        launches = launch_counts()
    finally:
        srv.stop()
    served = []
    for req, (status, r, ms) in zip(DEMO_REQUESTS, answers):
        if status != 200:
            raise AssertionError(f"{phase}: {req} answered {status}: {r}")
        with wave.open(io.BytesIO(base64.b64decode(r["wav_b64"])), "rb") as w:
            n, pcm = w.getnframes(), np.frombuffer(w.readframes(w.getnframes()), "<i2")
        fig = Image.open(io.BytesIO(base64.b64decode(r["mel_b64"])))
        strip = Image.open(io.BytesIO(base64.b64decode(r["image_b64"])))
        if (len(r["durations"]) != len(req["text"]) or n != r["mel_frames"] * HOP
                or not pcm.any() or fig.mode != "RGB" or fig.size != (FIG_WIDTH, PANEL_HEIGHT)
                or strip.height != synth.metadata.image_height):
            raise AssertionError(f"{phase}: {req} gave {n} samples for {r['mel_frames']} "
                                 f"frames, figure {fig.mode} {fig.size}, strip {strip.size}")
        served.append({"mel_frames": r["mel_frames"], "samples": n, "host_ms": ms})
    if dev.type == "cuda":
        per_call = per_call_launches(synth.model, synth.vocoder)
        expect_launches(phase, launches,
                        {k: v * len(DEMO_REQUESTS) for k, v in per_call.items()})
    say(phase, card=card, requests=len(DEMO_REQUESTS), answered=served,
        kernel_launches=launches)
    return {"launches": launches, "answered": served}


# phase 17: GAN vocoder training. The GAN step at B 16 x 8192 samples (the
# recipe's segment), fp32; warm-up and timed steps of HiFi-GAN V1, steps of
# the two other families. The first step on the card against the CPU at B 2,
# from the same initial state and batch: the D loss and the discriminators'
# gradient norm come from one forward and backward at equal parameters
# (1e-4 relative, as phase 13's first step); the G loss and the generator's
# gradient norm come after the discriminators' first Adam update, lr x the
# sign of each gradient, where a gradient of roundoff size can take the other
# sign on the card (1e-3 relative)
VOC_B, VOC_SEGMENT, VOC_WARMUP, VOC_TIMED, VOC_FAMILY_STEPS = 16, 8192, 3, 20, 5
VOC_FIRST_B = 2
VOC_FIRST_RTOL = {"d_total": 1e-4, "d_grad_norm": 1e-4, "g_total": 1e-3, "g_grad_norm": 1e-3}
VOC_EMA = 0.9999


def vocoder_clips():
    """The 20 train clips of `tools/vocoder_longrun_torch.py`'s corpus."""
    sys.path.insert(0, str(ROOT / "tools"))
    import vocoder_longrun_torch

    return vocoder_longrun_torch.corpus_and_gt("cpu")[0]


def vocoder_trainer(dev, clips, family: str = "hifigan", batch: int = VOC_B, **kw):
    """The port's `VocoderTrainer` for `family` with its recipe (lr, clip,
    MSD or MRD) at `batch` x VOC_SEGMENT, on `dev`; `compute_dtype=
    "bfloat16"` among `kw` builds every module in bf16."""
    from visual_onoma_to_wave_tpu_torch.models.hifigan_disc import MultiResolutionDiscriminator
    from visual_onoma_to_wave_tpu_torch.models.vocoder import get_vocoder
    from visual_onoma_to_wave_tpu_torch.precision import compute_dtype
    from visual_onoma_to_wave_tpu_torch.training.vocoder_trainer import (
        VocoderTrainConfig,
        VocoderTrainer,
        family_recipe,
    )

    recipe = family_recipe(family)
    pairs = kw.pop("pairs", None)
    cfg = VocoderTrainConfig(segment_size=VOC_SEGMENT, batch_size=batch,
                             learning_rate=recipe["learning_rate"],
                             grad_clip_norm=recipe["grad_clip_norm"], log_every=10 ** 9,
                             save_every=10 ** 9, **kw)
    dtype = compute_dtype(cfg.compute_dtype)
    msd = MultiResolutionDiscriminator(dtype=dtype) if recipe["disc"] == "mrd" else None
    return VocoderTrainer(clips, cfg, gen=get_vocoder(family, dtype=dtype), msd=msd, pairs=pairs,
                          device=dev)


def gan_steps(vt, steps: int, timed: bool = True) -> dict:
    """`steps` GAN steps of `vt` (each drawing its batch from the sampler),
    a CUDA event after each: the period of each step, batch and copy
    included; every loss finite."""
    marks, losses = [], []
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        batch = vt.sampler.next_batch()
        if isinstance(batch, tuple):
            m = vt.train_step(vt._to_device(batch[0]), vt._to_device(batch[1]))
        else:
            m = vt.train_step(vt._to_device(batch))
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
        marks.append(mark)
        losses.append(m)
    torch.cuda.synchronize()
    table = {k: [float(x[k]) for x in losses] for k in losses[0]}
    if not all(np.isfinite(v).all() for v in table.values()):
        raise AssertionError(f"GAN step of {vt.family}: a loss is not finite: {table}")
    ms = [start.elapsed_time(marks[0])] + [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return {"ms": ms, "losses": table}


def vocoder_first_step(dev, clips) -> dict:
    """The first GAN step of HiFi-GAN V1 at B VOC_FIRST_B on `dev` and on the
    CPU, from the same initial state (drawn on the CPU from the seed) and
    batch: losses and the gradients' global norms, VOC_FIRST_RTOL."""
    from visual_onoma_to_wave_tpu_torch.training.schedule import global_norm

    out = {}
    for where in (dev, torch.device("cpu")):
        vt = vocoder_trainer(where, clips, batch=VOC_FIRST_B)
        m = vt.train_step(vt._to_device(vt.sampler.next_batch()))
        out[where.type] = {
            "d_total": float(m["d_total"]), "g_total": float(m["g_total"]),
            "mel_l1": float(m["mel_l1"]),
            "d_grad_norm": float(global_norm([q.grad for q in vt.state.disc_opt.params])),
            "g_grad_norm": float(global_norm([q.grad for q in vt.state.gen_opt.params]))}
        del vt
    rel = {k: abs(out[dev.type][k] - out["cpu"][k]) / max(abs(out["cpu"][k]), 1e-12)
           for k in VOC_FIRST_RTOL}
    bad = {k: v for k, v in rel.items() if not v <= VOC_FIRST_RTOL[k]}
    if bad:
        raise AssertionError(f"first GAN step on {dev} vs the CPU: relative errors {bad} "
                             f"(bounds {VOC_FIRST_RTOL}): {out}")
    return {"on_card": out[dev.type], "on_cpu": out["cpu"], "rel_err": rel}


def vocoder_restore_and_serve(dev, vt, mel: torch.Tensor, work: pathlib.Path) -> dict:
    """Save `vt` (HiFi-GAN V1) under `work`, restore it into a fresh trainer
    bit for bit (parameters, both optimizers, EMA, sampler); a step holding
    HALTED.json is refused; the saved generator.npz through
    `synthesis.load_vocoder` in `.eval()` vocodes `mel`: one MRF kernel launch
    per stage, the waveform within VOCODE_ATOL of the plain chain."""
    from visual_onoma_to_wave_tpu_torch.config import Config
    from visual_onoma_to_wave_tpu_torch.synthesis import load_vocoder, vocode

    phase = "17c vocoder checkpoint"
    vt.ckpt_dir = work
    step = vt.state.step
    vt.save(step)
    saved = vt.full_state_arrays()
    fresh = vocoder_trainer(dev, vt.sampler.clips, ema_decay=VOC_EMA)
    fresh.ckpt_dir = work
    if fresh.restore() != step:
        raise AssertionError(f"{phase}: restored step {fresh.state.step}, saved {step}")
    got = fresh.full_state_arrays()
    exact = got.keys() == saved.keys() and all(np.array_equal(got[k], saved[k]) for k in saved)
    sampler = fresh.sampler.rng.bit_generator.state == vt.sampler.rng.bit_generator.state
    if not (exact and sampler):
        raise AssertionError(f"{phase}: restore is not bit-exact (state {exact}, "
                             f"sampler {sampler})")
    vt.save(step + 1)
    (work / str(step + 1) / "HALTED.json").write_text(json.dumps({"diverged_at": step + 1}))
    refused = []
    for s in (None, step + 1):
        try:
            fresh.restore(s)
        except ValueError as e:
            refused.append("not resumable" in str(e))
    if refused != [True, True]:
        raise AssertionError(f"{phase}: a HALTED.json step was resumed ({refused})")
    del fresh

    gen = load_vocoder(Config(), str(work / str(step) / "generator.npz")).to(dev).eval()
    want = mrf_stages(gen)
    zero_launch_counts()
    with torch.inference_mode():
        wav = vocode(gen, mel)
    torch.cuda.synchronize()
    launches = launch_counts()
    expect_launches(phase + " serve", launches, want)
    with torch.inference_mode(), plain_on_card(gen):
        plain = vocode(gen, mel)
    err = float((wav - plain).abs().max())
    check_vocode(f"{phase}: the trained generator through the MRF kernel vs the plain chain",
                 err, float(plain.abs().max()))
    return {"step": step, "restore_bit_exact": True, "arrays": len(saved),
            "halted_refused": True, "serve_launches": launches, "mel": list(mel.shape),
            "max_abs_err_vs_plain": err, "max_abs_plain": float(plain.abs().max()),
            "atol": VOCODE_ATOL}


def vocoder_pairs(dev, train_cfg) -> dict:
    """`teacher_forced_pairs` over phase 13's checkpoint and corpus: one eval
    pass of the acoustic model per train batch, each FFT block one attention
    launch; then VOC_FAMILY_STEPS paired fine-tuning steps of HiFi-GAN V1,
    no launch."""
    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer
    from visual_onoma_to_wave_tpu_torch.training.vocoder_trainer import teacher_forced_pairs

    phase = "17e teacher-forced pairs"
    trainer = Trainer(train_cfg, restore_step=TRAIN_STEPS, device=dev)
    model = trainer.state.model
    batches = len(trainer.train_ds.batch_plan(group_size=1, shuffle=False))
    blocks = len(model.encoder.layer_stack) + len(model.decoder.layer_stack)
    zero_launch_counts()
    pairs = teacher_forced_pairs(trainer)
    torch.cuda.synchronize()
    launches = launch_counts()
    expect_launches(phase, launches, {"flash_mha": batches * blocks})
    if not pairs or not all(len(a) == m.shape[0] * HOP and np.isfinite(m).all()
                            for a, m in pairs):
        raise AssertionError(f"{phase}: {len(pairs)} pairs, not frame-aligned or not finite")
    del trainer
    vt = vocoder_trainer(dev, None, pairs=pairs)
    zero_launch_counts()
    run = gan_steps(vt, VOC_FAMILY_STEPS)
    expect_launches(phase + " fine-tuning", launch_counts(), {})
    return {"pairs": len(pairs), "train_batches": batches, "fft_blocks": blocks,
            "launches": launches, "finetune_ms": run["ms"],
            "finetune_g_total": run["losses"]["g_total"]}


def phase_vocoder_training(dev, card: str, mel: torch.Tensor, train_cfg,
                           work: pathlib.Path) -> dict:
    """GAN vocoder training on the card (see the module docstring, phase 17)."""
    phase = "17 vocoder training"
    clips = vocoder_clips()
    audio_s = VOC_B * VOC_SEGMENT / SR
    torch.cuda.reset_peak_memory_stats(dev)
    vt = vocoder_trainer(dev, clips, ema_decay=VOC_EMA)
    zero_launch_counts()
    warm = gan_steps(vt, VOC_WARMUP)
    run = gan_steps(vt, VOC_TIMED)
    expect_launches(phase + " hifigan", launch_counts(), {})
    ms = float(np.median(run["ms"]))
    result = {"hifigan": {
        "params": {k: sum(q.numel() for q in m.parameters())
                   for k, m in (("gen", vt.gen), ("mpd", vt.mpd), ("msd", vt.msd))},
        "warmup_ms": warm["ms"], "step_ms_median": ms, "step_ms_mean": float(np.mean(run["ms"])),
        "audio_s_per_s": audio_s / (ms / 1e3),
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
        "g_total_first_last": [warm["losses"]["g_total"][0], run["losses"]["g_total"][-1]],
        "mel_l1_first_last": [warm["losses"]["mel_l1"][0], run["losses"]["mel_l1"][-1]]}}
    say(phase + " 17a hifigan v1", card=card, batch=VOC_B, segment=VOC_SEGMENT,
        kernel_launches=launch_counts(), **result["hifigan"])

    result["first_step"] = vocoder_first_step(dev, clips)
    say(phase + " 17b first step vs the CPU", card=card, batch=VOC_FIRST_B,
        rtol=VOC_FIRST_RTOL, **result["first_step"])

    result["checkpoint"] = vocoder_restore_and_serve(dev, vt, mel, work / "vocoder")
    say(phase + " 17c checkpoint", card=card, **result["checkpoint"])
    del vt

    for family in ("istftnet-mel", "bigvgan"):
        torch.cuda.reset_peak_memory_stats(dev)
        ft = vocoder_trainer(dev, clips, family)
        zero_launch_counts()
        run = gan_steps(ft, VOC_FAMILY_STEPS)
        expect_launches(f"{phase} {family}", launch_counts(), {})
        ms = float(np.median(run["ms"][1:]))
        result[family] = {"disc": type(ft.msd).__name__, "lr": ft.cfg.learning_rate,
                          "clip": ft.cfg.grad_clip_norm, "step_ms": run["ms"],
                          "step_ms_median_after_first": ms, "audio_s_per_s": audio_s / (ms / 1e3),
                          "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                          "g_total": run["losses"]["g_total"]}
        say(f"{phase} 17d {family}", card=card, batch=VOC_B, segment=VOC_SEGMENT,
            kernel_launches=launch_counts(), **result[family])
        del ft

    result["pairs"] = vocoder_pairs(dev, train_cfg)
    say(phase + " 17e teacher-forced pairs", card=card, **result["pairs"])
    return result



# phase 18: the exported artifact against the live path on the card. Both run
# the same kernels on the same inputs; the artifact's graph packs the MRF
# weights itself (the same values the live path caches), so the tolerances
# are the golden's: durations and mel lengths exact, mel 1e-4 and waveform
# 1e-5 absolute
EXPORT_ATOL = {"mel": 1e-4, "wav": 1e-5}
GOLDEN_REQUESTS = (("バウバウ", "bell", [1.0, 0.6, 1.0, 0.6], 1.0, 1.0),
                   ("チパチパチパ", "drum", None, 1.0, 1.0),
                   ("パシウドパシウド", "bell", None, 1.2, 1.0),
                   ("シトパリ", "drum", None, 1.0, 1.5))


def demo_synthesizer(dev, config: str = "config.json", vocoder: str = "vocoder.npz"):
    """`Synthesizer.from_checkpoint` on the committed demo weights, its
    metadata and vocabulary from the demo's preprocessed directory."""
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    cfg = load_config(DEMO / config)
    cfg = cfg.replace(path=cfg.path.__class__(
        corpus="", formatted="", preprocessed=str(DEMO / "preprocessed"), font="",
        ckpt="", log="", result=""))
    return Synthesizer.from_checkpoint(cfg, str(DEMO / "torch" / "acoustic.npz"),
                                       str(DEMO / "torch" / vocoder), device=dev)


def icassp_synthesizer(dev, vocoder: str, dtype: torch.dtype = torch.float32):
    """A `Synthesizer` around `icassp_b16`'s models (`icassp_bf16`'s in bf16):
    the ICASSP config, a vocabulary of 64 ids, 10 sound classes, cells of 24
    x 102 pixels."""
    import dataclasses

    from visual_onoma_to_wave_tpu_torch.config import Config, DatasetMetadata, FeatureStats
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    model, gen, batch = (icassp_b16(dev, vocoder) if dtype == torch.float32
                         else icassp_bf16(dev, vocoder))
    config = Config()
    config = config.replace(train=dataclasses.replace(config.train,
                                                      compute_dtype=str(dtype)[len("torch."):]))
    stats = FeatureStats(-2.0, 2.0, 0.0, 1.0)
    meta = DatasetMetadata(audiotype_map={f"class{i}": i for i in range(10)},
                           energy_stats=stats, kurtosis_stats=stats, max_pixelsize=102,
                           image_height=24, label_width={})
    symbols = {chr(0x30A0 + i): i for i in range(1, 64)}
    return Synthesizer(config, model, meta, symbols, gen, device=dev), batch


def artifact_bytes(d: pathlib.Path) -> int:
    return sum(f.stat().st_size for f in d.rglob("*") if f.is_file())


def check_artifact(phase: str, got, want) -> dict:
    """`synthesize_batch` results of the artifact against the live path's."""
    err = {"mel": 0.0, "wav": 0.0}
    for g, w in zip(got, want):
        if g.mel_len != w.mel_len or not np.array_equal(g.durations, w.durations):
            raise AssertionError(f"{phase}: mel_len {g.mel_len} / durations {g.durations} vs "
                                 f"live {w.mel_len} / {w.durations}")
        for k in err:
            err[k] = max(err[k], float(np.abs(getattr(g, k) - getattr(w, k)).max()))
    for k, tol in EXPORT_ATOL.items():
        if err[k] > tol:
            raise AssertionError(f"{phase}: artifact {k} off the live path by {err[k]:.3e} > {tol}")
    return err


def phase_export(dev, card: str, tmp: pathlib.Path) -> dict:
    """(a) The demo synthesizer exported for `cuda`, loaded in a fresh
    `ExportedSynthesizer`, serving the 4 golden requests against the live
    path (EXPORT_ATOL; one B1 launch per FFT block and one B2 launch per MRF
    stage through the artifact), then 4 concurrent HTTP requests through
    `BatchingServer` over it. (b) The ICASSP B16 HiFi-GAN V1 synthesizer of
    phase 4 exported and run at phase 4's batch: B1 10 and B2 4 launches a
    call, its outputs against the live fused step, artifact vs live ms (CUDA
    events after warmup), export and load seconds, artifact bytes. (c) The
    same with mel-Vocos at its published widths: B4 8 launches a call."""
    import base64
    import http.client
    import threading
    import time

    from visual_onoma_to_wave_tpu_torch.export import ExportedSynthesizer, export_synthesizer
    from visual_onoma_to_wave_tpu_torch.serve import BatchingServer
    from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer

    phase = "18 export"
    result = {}
    synth = demo_synthesizer(dev)
    t0 = time.perf_counter()
    export_synthesizer(synth, tmp / "demo", max_batch=4, text_lens=(4, 8), devices=(dev.type,))
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exp = ExportedSynthesizer.load(tmp / "demo", device=dev.type)
    load_s = time.perf_counter() - t0
    texts, types, rates, e, d = zip(*GOLDEN_REQUESTS)
    kw = dict(width_rates=list(rates), e_control=list(e), d_control=list(d))
    live = synth.synthesize_batch(list(texts), list(types), **kw)
    zero_launch_counts()
    got = exp.synthesize_batch(list(texts), list(types), **kw)
    per_call = per_call_launches(synth.model, synth.vocoder) if dev.type == "cuda" else {}
    expect_launches(phase + " demo", launch_counts(), per_call)
    err = check_artifact(phase + " demo", got, live)
    answers = [None] * 4
    srv = BatchingServer(exp, port=0, max_batch=4, batch_window_ms=50.0)
    srv.warmup()
    srv.reset_stats()

    def post(i):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=120)
        try:
            body = {"text": texts[i], "audiotype": types[i], "e_control": e[i],
                    "d_control": d[i]}
            conn.request("POST", "/v1/synthesize", json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            answers[i] = (resp.status, json.loads(resp.read()))
        finally:
            conn.close()

    zero_launch_counts()
    srv.start()
    try:
        threads = [threading.Thread(target=post, args=(i,)) for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        stats = srv.snapshot_stats()
    finally:
        srv.stop()
    for i, ans in enumerate(answers):
        if ans is None or ans[0] != 200 or len(base64.b64decode(ans[1]["wav_b64"])) < \
                ans[1]["mel_frames"] * HOP * 2:
            raise AssertionError(f"{phase} http: request {i} answered {ans and ans[0]}")
    expect_launches(phase + " http", launch_counts(),
                    {k: v * stats["batches"] for k, v in per_call.items()})
    result["demo"] = {"export_s": export_s, "load_s": load_s,
                      "artifact_bytes": artifact_bytes(tmp / "demo"), "max_abs_err": err,
                      "atol": EXPORT_ATOL, "launches_per_call": per_call,
                      "http_answered_200": 4, "http_batches": stats["batches"]}
    say(phase + " demo", card=card, **result["demo"])

    for vocoder, key in (("HiFi-GAN", "icassp_hifigan_v1"), ("Vocos", "icassp_vocos")):
        synth, batch = icassp_synthesizer(dev, vocoder)
        out_dir = tmp / key
        t0 = time.perf_counter()
        export_synthesizer(synth, out_dir, max_batch=B, text_lens=(C,), devices=(dev.type,))
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        exp = ExportedSynthesizer.load(out_dir, device=dev.type)
        load_s = time.perf_counter() - t0
        args = (batch["audiotypes"].int(), batch["texts"].int(), batch["src_lens"].int(),
                torch.ones(B, device=dev), torch.ones(B, device=dev))
        program = functools.partial(exp._program, *args, image_cells=batch["image_cells"])
        fused = make_fused_infer(synth.model, synth.vocoder)
        with torch.inference_mode():
            want = fused(batch)
            zero_launch_counts()
            got = program()
            per_call = per_call_launches(synth.model, synth.vocoder) if dev.type == "cuda" else {}
            expect_launches(f"{phase} {key}", launch_counts(), per_call)
            mel_err = float((got[0] - want["postnet_mel"]).abs().max())
            wav_err = float((got[4] - want["wav"]).abs().max())
            if not torch.equal(got[1], want["mel_lens"]) or mel_err > EXPORT_ATOL["mel"] or \
                    wav_err > EXPORT_ATOL["wav"]:
                raise AssertionError(f"{phase} {key}: artifact off the live path: mel_lens "
                                     f"equal {torch.equal(got[1], want['mel_lens'])}, mel "
                                     f"{mel_err:.3e}, wav {wav_err:.3e}")
            artifact_ms = live_ms = artifact_ms_again = None
            if dev.type == "cuda":    # artifact, live, artifact: both under the same clocks
                artifact_ms = time_cuda(program, 5, warmup=2)
                live_ms = time_cuda(lambda: fused(batch), 5, warmup=2)
                artifact_ms_again = time_cuda(program, 5, warmup=0)
        result[key] = {"export_s": export_s, "load_s": load_s,
                       "artifact_bytes": artifact_bytes(out_dir),
                       "parameters": sum(p.numel() for m in (synth.model, synth.vocoder)
                                         for p in m.parameters()),
                       "launches_per_call": per_call, "max_abs_err": {"mel": mel_err,
                                                                     "wav": wav_err},
                       "artifact_ms": [artifact_ms, artifact_ms_again], "live_ms": live_ms,
                       "mel_lens": got[1].tolist()}
        say(f"{phase} {key}", card=card, batch=B, chars=C, **result[key])
        del exp, program
    return result


# phase 19: the data-parallel step through an nccl group of one process
# against the plain step from the same state. With one process every
# all-reduce is the identity; what differs is the order of the sums (the
# BatchNorms' sum / count against mean), so the bounds are those of the
# CPU test of two processes: losses within 1e-5 relative, parameters within
# 1e-6 absolute where the gradient is resolved (>= 1e-2 of its leaf's RMS,
# in a leaf whose RMS is >= 1e-4 of the whole gradient's: Adam's first
# update moves roundoff-size gradients by +-lr either way); the sharded
# synthesizer over the card's one device within 1e-5 of the live batch
DP_LOSS_RTOL, DP_PARAM_ATOL, SHARDED_ATOL = 1e-5, 1e-6, 1e-5


def dp_batch(dev) -> dict:
    """A training batch of phase 4's acoustic model: B 16, 8 characters,
    mels of 480 frames (4 items shorter), random targets from seed 0."""
    rng = np.random.default_rng(0)
    dur = np.full((B, C), 60, np.int32)
    dur[-4:, -2:] = 0
    b = {"audiotypes": (np.arange(B) % 10).astype(np.int32),
         "texts": rng.integers(1, 64, (B, C)).astype(np.int32),
         "src_lens": np.full((B,), C, np.int32),
         "image_cells": rng.uniform(0, 1, (B, C, 24, 102)).astype(np.float32),
         "mels": rng.standard_normal((B, 480, 80)).astype(np.float32),
         "energies": rng.standard_normal((B, C)).astype(np.float32),
         "durations": dur}
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def phase_scale_out(dev, card: str) -> dict:
    """An nccl process group of one on the card: one data-parallel train
    step (global BatchNorm statistics, global loss counts, the gradient
    all-reduce, dropout on) of phase 4's acoustic model against the plain
    step from the same state, both timed; then `make_sharded_synth` over the
    card's device list against the live fused step. Nothing here measures
    NCCL across cards: the machine has one."""
    import copy
    import socket

    import torch.distributed as dist

    from visual_onoma_to_wave_tpu_torch.parallel import init_distributed, make_sharded_synth
    from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer
    from visual_onoma_to_wave_tpu_torch.training.schedule import NoamAdam
    from visual_onoma_to_wave_tpu_torch.training.train_state import TrainState, train_step

    phase = "19 scale-out"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0, device=dev.type)
    try:
        model, gen, batch = icassp_b16(dev, "HiFi-GAN")
        train_batch = dp_batch(dev)
        out, states = {}, {}
        for name, shard in (("plain", None), ("data_parallel", (0, 1))):
            m = copy.deepcopy(model).train()
            state = TrainState(m, NoamAdam(m.parameters(), init_lr=1e-3, warmup_steps=400),
                               torch.Generator(device=dev).manual_seed(1), shard=shard)
            zero_launch_counts()
            losses = train_step(state, train_batch)
            expect_launches(f"{phase} {name}", launch_counts(), {})
            out[name] = {k: float(v) for k, v in losses.items()}
            out[name + "_grads"] = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
            states[name] = state
        rel = {k: abs(out["data_parallel"][k] - v) / max(abs(v), 1e-12)
               for k, v in out["plain"].items()}
        if max(rel.values()) > DP_LOSS_RTOL:
            raise AssertionError(f"{phase}: the data-parallel step's losses off the plain "
                                 f"step's: {rel}")
        grads = out["plain_grads"]
        rms = float(torch.sqrt(sum((g * g).sum() for g in grads.values())
                               / sum(g.numel() for g in grads.values())))
        worst, compared = 0.0, 0
        dp_params = dict(states["data_parallel"].model.named_parameters())
        for n, p in states["plain"].model.named_parameters():
            g = grads[n]
            leaf = float(torch.sqrt((g * g).mean()))
            resolved = (g.abs() >= 1e-2 * leaf) & (leaf >= 1e-4 * rms)
            if resolved.any():
                worst = max(worst, float((dp_params[n] - p).detach()[resolved].abs().max()))
                compared += int(resolved.sum())
        if worst > DP_PARAM_ATOL:
            raise AssertionError(f"{phase}: parameters after the data-parallel step off the "
                                 f"plain step's by {worst:.3e} > {DP_PARAM_ATOL}")
        step_ms = {name: time_cuda(lambda st=st: train_step(st, train_batch), 3, warmup=1)
                   for name, st in states.items()} if dev.type == "cuda" else None
        del states, out["plain_grads"], out["data_parallel_grads"]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        fused = make_fused_infer(model, gen)
        host = {k: v.cpu().numpy() for k, v in batch.items()}
        run = make_sharded_synth(model, gen, [dev])
        with torch.inference_mode():
            want = fused(batch)
        zero_launch_counts()
        wavs, lens = run(host)
        expect_launches(phase + " sharded synth", launch_counts(),
                        per_call_launches(model, gen) if dev.type == "cuda" else {})
        sharded_err = float(np.abs(wavs - want["wav"].cpu().numpy()).max())
        if not np.array_equal(lens, want["mel_lens"].cpu().numpy()) or sharded_err > SHARDED_ATOL:
            raise AssertionError(f"{phase}: sharded synth off the live batch by {sharded_err:.3e}")
    finally:
        dist.destroy_process_group()
    result = {"backend": "nccl" if dev.type == "cuda" else "gloo", "world_size": 1, "losses": out["data_parallel"],
              "loss_max_rel_err": max(rel.values()), "loss_rtol": DP_LOSS_RTOL,
              "param_max_abs_err_resolved": worst, "param_elements_compared": compared,
              "param_atol": DP_PARAM_ATOL, "step_ms": step_ms,
              "sharded_devices": [str(dev)], "sharded_max_abs_err": sharded_err,
              "sharded_atol": SHARDED_ATOL,
              "note": "one card: nothing here measures NCCL across GPUs"}
    say(phase, card=card, **result)
    return result


# phase 20: bf16 compute where the JAX package runs it. Bounds, stated before
# the run: the bf16 path with its kernels against the same bf16 path with the
# plain versions on the card, within BF16_VS_PLAIN_OF_SCALE of the plain
# output's max (the slice bound of the CPU tests against JAX: the kernels
# round at other points than their plain versions, B1 the unnormalised
# probabilities, B2 its residual streams kept fp32, and a flipped bf16
# rounding travels down the network); the bf16 vocoders against the fp32
# ones on phase 4's fp32 mel by the JAX package's own bf16 tests: HiFi-GAN
# V1 and iSTFTNet-mel (HiFi-GAN's trunk) max error < 0.05 and relative L2 <
# 0.05 (tests/test_hifigan.py:136), Vocos max error < 0.1 of max |fp32|
# (tests/test_vocos.py:91); the bf16 acoustic model teacher-forced with the
# fp32 run's durations against the fp32 postnet mel, mean relative error <
# 0.1 (tests/test_training.py:126); the exported bf16 artifact against the
# live bf16 step within EXPORT_ATOL
BF16_VS_PLAIN_OF_SCALE = 5e-2
BF16_VS_FP32 = {"HiFi-GAN": {"max_abs": 0.05, "rel_l2": 0.05},
                "iSTFTNet-mel": {"max_abs": 0.05, "rel_l2": 0.05},
                "Vocos": {"max_of_scale": 0.1}}
BF16_MEL_MEAN_REL = 0.1
BF16_TRAIN_STEPS, BF16_GAN_STEPS = 3, 4
# the phase's fp32 numbers to print beside bf16 (phases 4, 6, 10)
SERVED_KEYS = ("acoustic_ms", "vocoder_ms", "synthesis_ms", "synthesis_x_realtime",
               "peak_mem_gib")


@contextlib.contextmanager
def kernel_operand_dtypes():
    """While the context lasts, records the operand dtype of every call the
    models make to the attention, MRF and ConvNeXt block kernels, by kernel
    record name: through the names `models/layers.py` and `models/vocos.py`
    call (`attention_core`, `convnext_block`) and through
    `ops/mrf.py::MRFStages.__call__`, so that the wrappers themselves, and
    the launch counts they keep, are untouched."""
    import visual_onoma_to_wave_tpu_torch.models.layers as layers
    import visual_onoma_to_wave_tpu_torch.models.vocos as vocos
    from visual_onoma_to_wave_tpu_torch.ops.mrf import MRFStages, mrf_route, sm_count

    seen = {"flash_mha": set(), **{name: set() for name in MRF_RECORD.values()},
            "convnext_block": set()}
    attention, block, stage = layers.attention_core, vocos.convnext_block, MRFStages.__call__

    def note(name, x):
        seen[name].add(str(x.dtype)[len("torch."):])

    def attention_call(q, *args, **kw):
        note("flash_mha", q)
        return attention(q, *args, **kw)

    def block_call(x, *args, **kw):
        note("convnext_block", x)
        return block(x, *args, **kw)

    def stage_call(self, i, blocks, x, fused=True):
        if fused:
            note(MRF_RECORD[mrf_route(x.shape[1], x.dtype, self.kernel_sizes, self.dilations,
                                      x.shape[0], x.shape[2], sm_count(x.device))], x)
        return stage(self, i, blocks, x, fused)

    layers.attention_core, vocos.convnext_block = attention_call, block_call
    MRFStages.__call__ = stage_call
    try:
        yield seen
    finally:
        layers.attention_core, vocos.convnext_block = attention, block
        MRFStages.__call__ = stage


@contextlib.contextmanager
def plain_attention():
    """While the context lasts, every attention of the acoustic model takes
    `attention_core_reference` on the card (the plain version B1 is held
    to)."""
    import visual_onoma_to_wave_tpu_torch.models.layers as layers

    kernel = layers.attention_core
    layers.attention_core = layers.attention_core_reference
    try:
        yield
    finally:
        layers.attention_core = kernel


def _of_scale(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-6))


def bf16_served(dev, card: str, vocoder: str, fp32: dict) -> dict:
    """Phase 20 (a) for one vocoder: the bf16 fused step at phase 4's batch,
    its launches and their operand dtype, against the same bf16 path with
    the plain versions on the card and against fp32; timed beside `fp32`
    (that phase's numbers)."""
    from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer

    phase = f"20 bf16 {vocoder}"
    torch.cuda.reset_peak_memory_stats(dev)
    model16, gen16, batch = icassp_bf16(dev, vocoder)
    model, gen, _ = icassp_b16(dev, vocoder)
    fused16 = make_fused_infer(model16, gen16)
    zero_launch_counts()
    with kernel_operand_dtypes() as seen:
        out = fused16(batch)
        torch.cuda.synchronize()
    launches = launch_counts()
    per_call = per_call_launches(model16, gen16, tuple(out["postnet_mel"].shape[:2]))
    expect_launches(phase, launches, per_call)
    dtypes = {k: sorted(v) for k, v in seen.items() if v}
    if any(v != ["bfloat16"] for v in dtypes.values()) or \
            set(dtypes) != {k for k, n in per_call.items() if n}:
        raise AssertionError(f"{phase}: kernel operand dtypes {dtypes}, expected bfloat16 for "
                             f"every kernel of {per_call}")
    wav, mel_lens = out["wav"], out["mel_lens"]
    if wav.dtype != torch.float32 or not bool(torch.isfinite(wav).all()) or \
            not bool(torch.isfinite(out["postnet_mel"]).all()):
        raise AssertionError(f"{phase}: waveform {wav.dtype}, finite "
                             f"{bool(torch.isfinite(wav).all())}")
    mel = out["postnet_mel"]
    inputs = {k: batch[k] for k in ("audiotypes", "texts", "src_lens", "image_cells")}
    with torch.inference_mode():
        # the same bf16 path through the plain versions, teacher-forced with
        # the kernel run's durations (a flipped duration would move frames)
        with plain_attention():
            plain_mel = model16(**inputs, duration_targets=out["duration_rounded"])["postnet_mel"]
        with plain_on_card(gen16):
            plain_wav = gen16(mel)
        ours = {"mel": _of_scale(mel, plain_mel), "wav": _of_scale(wav, plain_wav)}
        # bf16's own effect on the mel beside it: the plain bf16 mel against
        # the fp32 mel on the same durations
        fp32_mel = model(**inputs, duration_targets=out["duration_rounded"])["postnet_mel"]
        mel_reading = {"kernel_vs_plain": ours["mel"],
                       "plain_bf16_vs_fp32": _of_scale(plain_mel, fp32_mel)}
        # against fp32: the vocoders on the fp32 mel, the acoustic model
        # teacher-forced with the fp32 run's durations
        out32 = make_fused_infer(model, gen)(batch)
        w32, w16 = gen(out32["postnet_mel"]), gen16(out32["postnet_mel"])
        tf16 = model16(**inputs, duration_targets=out32["duration_rounded"])["postnet_mel"]
    zero_launch_counts()
    m32 = out32["postnet_mel"]
    vs_fp32 = {"max_abs": float((w16 - w32).abs().max()),
               "rel_l2": float(torch.linalg.vector_norm(w16 - w32)
                               / (torch.linalg.vector_norm(w32) + 1e-9)),
               "max_of_scale": _of_scale(w16, w32),
               "mel_mean_rel": float((tf16 - m32).abs().mean() / (m32.abs().mean() + 1e-6))}
    lens32 = out32["mel_lens"]
    mel_len_moves = {"items": int((mel_lens != lens32).sum()),
                     "max_frames": int((mel_lens - lens32).abs().max())}
    bounds = BF16_VS_FP32[vocoder]
    if max(ours.values()) > BF16_VS_PLAIN_OF_SCALE or \
            any(vs_fp32[k] >= v for k, v in bounds.items()) or \
            vs_fp32["mel_mean_rel"] >= BF16_MEL_MEAN_REL:
        raise AssertionError(f"{phase}: kernels vs plain {ours} (bound "
                             f"{BF16_VS_PLAIN_OF_SCALE} of max), vs fp32 {vs_fp32} (bounds "
                             f"{bounds}, mel mean relative {BF16_MEL_MEAN_REL})")
    acoustic = lambda: model16(**inputs)  # noqa: E731
    with torch.inference_mode():
        acoustic_ms = time_cuda(acoustic, 5, warmup=2)
        vocoder_ms = time_cuda(lambda: gen16(mel), 5, warmup=2)
    synthesis_ms = time_cuda(lambda: fused16(batch), 5, warmup=2)
    audio_s = int(mel_lens.sum()) * HOP / SR
    result = {"acoustic_ms": acoustic_ms, "vocoder_ms": vocoder_ms, "synthesis_ms": synthesis_ms,
              "synthesis_x_realtime": audio_s / (synthesis_ms / 1e3),
              "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
              "launches": launches}
    say(phase, card=card, batch=B, chars=C, mel_lens=mel_lens.tolist(),
        kernel_launches_per_call=launches, kernel_operand_dtypes=dtypes,
        kernels_vs_plain_of_max=ours, kernels_vs_plain_bound=BF16_VS_PLAIN_OF_SCALE,
        mel_of_max=mel_reading, vs_fp32=vs_fp32, vs_fp32_bounds={**bounds, "mel_mean_rel": BF16_MEL_MEAN_REL},
        mel_len_moves_vs_fp32=mel_len_moves,
        **{k: v for k, v in result.items() if k != "launches"},
        fp32={k: fp32[k] for k in SERVED_KEYS})
    return result


def bf16_training(dev, card: str, fp32_steps: dict) -> dict:
    """Phase 20 (b): BF16_TRAIN_STEPS bf16 train steps of phase 4's acoustic
    model on phase 19's batch beside the fp32 step on the same batch, then
    BF16_GAN_STEPS bf16 GAN steps of HiFi-GAN V1 against MPD + MSD at B 16 x
    8192 (`VocoderTrainConfig(compute_dtype="bfloat16")`); losses finite,
    parameters fp32, no kernel launched."""
    import copy

    from visual_onoma_to_wave_tpu_torch.training.schedule import NoamAdam
    from visual_onoma_to_wave_tpu_torch.training.train_state import TrainState, train_step

    phase = "20 bf16 training"
    train_batch = dp_batch(dev)
    steps = {}
    for name, (model, _, _) in (("fp32", icassp_b16(dev, "HiFi-GAN")),
                                ("bf16", icassp_bf16(dev, "HiFi-GAN"))):
        m = copy.deepcopy(model).train()
        state = TrainState(m, NoamAdam(m.parameters(), init_lr=1e-3, warmup_steps=400),
                           torch.Generator(device=dev).manual_seed(1))
        ms, losses = [], []
        zero_launch_counts()
        for _ in range(BF16_TRAIN_STEPS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            losses.append({k: float(v) for k, v in train_step(state, train_batch).items()})
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        expect_launches(f"{phase} acoustic {name}", launch_counts(), {})
        if not all(np.isfinite(v) for step in losses for v in step.values()) or \
                any(p.dtype != torch.float32 for p in m.parameters()):
            raise AssertionError(f"{phase} acoustic {name}: losses {losses}, parameter dtypes "
                                 f"{sorted({str(p.dtype) for p in m.parameters()})}")
        steps[name] = {"step_ms": ms, "total_loss": [s["total_loss"] for s in losses]}
        del m, state
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    vt = vocoder_trainer(dev, vocoder_clips(), compute_dtype="bfloat16")
    zero_launch_counts()
    warm = gan_steps(vt, 1)
    run = gan_steps(vt, BF16_GAN_STEPS - 1)
    expect_launches(phase + " gan", launch_counts(), {})
    if any(p.dtype != torch.float32 for m in (vt.gen, vt.mpd, vt.msd) for p in m.parameters()) \
            or {vt.gen.dtype, vt.mpd.dtype, vt.msd.dtype} != {torch.bfloat16}:
        raise AssertionError(f"{phase} gan: modules or parameters in the wrong dtype")
    ms = float(np.median(run["ms"]))
    steps["gan_bf16"] = {"step_ms": warm["ms"] + run["ms"], "step_ms_median_after_first": ms,
                         "audio_s_per_s": VOC_B * VOC_SEGMENT / SR / (ms / 1e3),
                         "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                         "g_total": warm["losses"]["g_total"] + run["losses"]["g_total"]}
    del vt
    torch.cuda.empty_cache()
    say(phase, card=card, acoustic_batch=B, acoustic_mel_frames=480, gan_batch=VOC_B,
        gan_segment=VOC_SEGMENT, **steps, fp32_phase13_step_ms_median=fp32_steps["acoustic"],
        fp32_phase17_gan_step_ms_median=fp32_steps["gan"])
    return steps


def bf16_export(dev, card: str, tmp: pathlib.Path) -> dict:
    """Phase 20 (c): the bf16 ICASSP B16 HiFi-GAN V1 synthesizer exported,
    loaded and run at phase 4's batch against the live bf16 step."""
    import time

    from visual_onoma_to_wave_tpu_torch.export import ExportedSynthesizer, export_synthesizer
    from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer

    phase = "20 bf16 export"
    synth, batch = icassp_synthesizer(dev, "HiFi-GAN", torch.bfloat16)
    t0 = time.perf_counter()
    manifest = export_synthesizer(synth, tmp / "icassp_bf16", max_batch=B, text_lens=(C,),
                                  devices=(dev.type,))
    export_s = time.perf_counter() - t0
    exp = ExportedSynthesizer.load(tmp / "icassp_bf16", device=dev.type)
    args = (batch["audiotypes"].int(), batch["texts"].int(), batch["src_lens"].int(),
            torch.ones(B, device=dev), torch.ones(B, device=dev))
    program = functools.partial(exp._program, *args, image_cells=batch["image_cells"])
    fused = make_fused_infer(synth.model, synth.vocoder)
    with torch.inference_mode():
        want = fused(batch)
        zero_launch_counts()
        got = program()
        per_call = per_call_launches(synth.model, synth.vocoder, tuple(got[0].shape[:2]))
        expect_launches(phase, launch_counts(), per_call)
        err = {"mel": float((got[0] - want["postnet_mel"]).abs().max()),
               "wav": float((got[4] - want["wav"]).abs().max())}
        if not torch.equal(got[1], want["mel_lens"]) or any(err[k] > EXPORT_ATOL[k] for k in err):
            raise AssertionError(f"{phase}: artifact off the live bf16 step: mel_lens equal "
                                 f"{torch.equal(got[1], want['mel_lens'])}, {err}")
        artifact_ms = time_cuda(program, 5, warmup=2)
        live_ms = time_cuda(lambda: fused(batch), 5, warmup=2)
    result = {"dtypes": [manifest["acoustic_dtype"], manifest["vocoder_dtype"]],
              "export_s": export_s, "artifact_bytes": artifact_bytes(tmp / "icassp_bf16"),
              "launches_per_call": per_call, "max_abs_err": err, "atol": EXPORT_ATOL,
              "artifact_ms": artifact_ms, "live_ms": live_ms}
    say(phase, card=card, batch=B, chars=C, **result)
    return result


def phase_bf16(dev, card: str, fp32_served: dict, fp32_steps: dict,
               tmp: pathlib.Path) -> dict:
    """Phase 20: bf16 compute on the served path (HiFi-GAN V1, iSTFTNet-mel
    and mel-Vocos), in training and in the exported artifact."""
    served = {v: bf16_served(dev, card, v, fp32_served[v])
              for v in ("HiFi-GAN", "iSTFTNet-mel", "Vocos")}
    return {"served": served, "training": bf16_training(dev, card, fp32_steps),
            "export": bf16_export(dev, card, tmp)}


# phase 21: the rest of the JAX package's surface. Bounds, stated before the
# run: serving a checkpoint through `restore_step` is the same computation as
# through its `acoustic.npz`, bit for bit; one batch split over two replicas
# on the card against one replica within SHARD_OF_SCALE of the output's max
# (other batch sizes take other GEMM tilings); B3's log-mel on two shares of
# a batch bit for bit what it gives on the whole batch (each clip is its own
# blocks' work), the char energy and kurtosis after it within
# CHAR_STATS_OF_SCALE of their max (`scatter_add_` sums the frames with
# atomics on the card, in no fixed order); griffin_lim on the card against
# the CPU within GL_OF_SCALE of max (cuFFT against pocketfft, 30 iterations)
SHARD_OF_SCALE, GL_OF_SCALE, CHAR_STATS_OF_SCALE = 1e-5, 1e-4, 1e-6
SURFACE_TEXTS = ("パンドン", "パン")


def surface_checkpoint(dev, card: str, cfg, work: pathlib.Path) -> dict:
    """Phase 21 (a): phase 13's checkpoint served through `restore_step`
    against its `acoustic.npz` given, the checkpoint's vocabulary, and `cli
    synthesize --restore-step -1` in a subprocess on the card."""
    import wave

    from visual_onoma_to_wave_tpu_torch.data.symbols import load_symbol_map
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer
    from visual_onoma_to_wave_tpu_torch.utils.checkpoint import acoustic_path

    import time

    phase = "21a checkpoint serving"
    latest = acoustic_path(cfg.path.ckpt)
    synth = Synthesizer.from_checkpoint(cfg, restore_step=-1, device=dev)
    given = Synthesizer.from_checkpoint(cfg, str(latest), device=dev)
    types = ["drum"] * len(SURFACE_TEXTS)
    zero_launch_counts()
    got = synth.synthesize_batch(list(SURFACE_TEXTS), types)
    launches = launch_counts()
    expect_launches(phase, launches,
                    {"flash_mha": len(synth.model.encoder.layer_stack)
                     + len(synth.model.decoder.layer_stack)})
    want = given.synthesize_batch(list(SURFACE_TEXTS), types)
    same = all(np.array_equal(a.mel, b.mel) and np.array_equal(a.durations, b.durations)
               for a, b in zip(got, want))
    vocab = synth.symbol_map == load_symbol_map(cfg.path.ckpt)
    if not (same and vocab):
        raise AssertionError(f"{phase}: restore_step serving equal {same}, checkpoint "
                             f"vocabulary {vocab}")
    data = cfg.to_dict()
    data["model"]["vocoder_kwargs"] = {"upsample_initial_channel": 128}    # the demo HiFi-GAN
    cfg_path, wav_path = work / "surface_config.json", work / "surface.wav"
    cfg_path.write_text(json.dumps(data))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "visual_onoma_to_wave_tpu_torch.cli",
                           "synthesize", str(cfg_path), "--restore-step", "-1", "--vocoder",
                           str(DEMO / "torch" / "vocoder.npz"), "--text", SURFACE_TEXTS[0],
                           "--audiotype", "drum", "--out", str(wav_path)],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{phase}: cli synthesize --restore-step -1 exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    frames = int(proc.stdout.split("mel frames:")[1].split(",")[0])
    with wave.open(str(wav_path), "rb") as w:
        n, pcm = w.getnframes(), np.frombuffer(w.readframes(w.getnframes()), np.int16)
    if frames != got[0].mel_len or n != frames * HOP or not np.abs(pcm).max() > 0:
        raise AssertionError(f"{phase}: the CLI's wav has {n} samples for {frames} mel "
                             f"frames (in process {got[0].mel_len})")
    result = {"checkpoint": str(latest.parent.name), "launches": launches,
              "restore_step_bit_equal": same, "checkpoint_vocabulary": vocab,
              "cli_mel_frames": frames, "cli_wav_samples": n, "cli_s": cli_s}
    say(phase, card=card, **result)
    return result


def surface_sharded(dev, card: str) -> dict:
    """Phase 21 (b): phase 4's batch over two replicas on the card
    (`make_sharded_fused` over [dev, dev]) against the one-replica fused
    step, and an odd batch of 5 requests through a two-device `Synthesizer`
    (padded to 8) against a one-device one; B1 and B2 launched per replica."""
    from visual_onoma_to_wave_tpu_torch.parallel import make_sharded_fused
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer, make_fused_infer

    phase = "21b sharded serving"
    synth, batch = icassp_synthesizer(dev, "HiFi-GAN")
    model, gen = synth.model, synth.vocoder
    per_call = per_call_launches(model, gen)
    twice = {k: 2 * v for k, v in per_call.items()}
    run = make_sharded_fused(model, gen, [dev, dev])
    with torch.inference_mode():
        want = make_fused_infer(model, gen)(batch)
    zero_launch_counts()
    got = run({k: v.cpu().numpy() for k, v in batch.items()})
    expect_launches(phase + " B16", launch_counts(), twice)
    err = {k: float(np.abs(got[k] - want[k].cpu().numpy()).max()
                    / want[k].abs().max().item()) for k in ("postnet_mel", "wav")}
    if (not np.array_equal(got["mel_lens"], want["mel_lens"].cpu().numpy())
            or not max(err.values()) <= SHARD_OF_SCALE):
        raise AssertionError(f"{phase}: two replicas off one at B{B}: {err}")
    sharded = Synthesizer(synth.config, model, synth.metadata, synth.symbol_map, gen,
                          device=dev, devices=[dev, dev])
    rng = np.random.default_rng(0)
    chars = sorted(synth.symbol_map)
    texts = ["".join(rng.choice(chars, int(n))) for n in rng.integers(3, C + 1, 5)]
    classes = sorted(synth.metadata.audiotype_map)
    types = [classes[i % len(classes)] for i in range(5)]
    zero_launch_counts()
    odd = sharded.synthesize_batch(texts, types, return_mel=True)
    expect_launches(phase + " B5", launch_counts(), twice)
    ref = synth.synthesize_batch(texts, types, return_mel=True)
    odd_err = {}
    for k in ("mel", "wav"):
        scale = max(float(np.abs(getattr(r, k)).max()) for r in ref)
        odd_err[k] = max(float(np.abs(getattr(a, k) - getattr(r, k)).max())
                         for a, r in zip(odd, ref)) / scale
    if (any(a.mel_len != r.mel_len for a, r in zip(odd, ref))
            or not max(odd_err.values()) <= SHARD_OF_SCALE):
        raise AssertionError(f"{phase}: a 5-request batch over two replicas off one: {odd_err}")
    result = {"devices": [str(dev)] * 2, "launches_b16": twice, "of_scale_b16": err,
              "padded_batch": sharded.batch_signature(texts)[0], "of_scale_b5": odd_err,
              "bound_of_scale": SHARD_OF_SCALE,
              "sharded_ms_b16": time_cuda(lambda: run({k: v.cpu().numpy()
                                                       for k, v in batch.items()}), 3),
              "one_replica_ms_b16": time_cuda(lambda: synth._run(
                  {k: v.cpu().numpy() for k, v in batch.items()},
                  np.ones(B, np.float32), np.ones(B, np.float32)), 3)}
    say(phase, card=card, **result)
    return result


def surface_features(dev, card: str) -> dict:
    """Phase 21 (c): phase 7's first batch of 64 clips through B3 over
    [dev, dev] against one device: two launches, the log-mel bit for bit."""
    from visual_onoma_to_wave_tpu_torch.data.features import extract_features

    phase = "21c sharded features"
    clips, durs = feature_clips()
    clips, durs = clips[:64], durs[:64]
    one = extract_features(clips, durs, device=dev, max_chars=MAX_CHARS)
    zero_launch_counts()
    two = extract_features(clips, durs, device=dev, max_chars=MAX_CHARS, devices=[dev, dev])
    torch.cuda.synchronize(dev)
    launches = launch_counts()
    expect_launches(phase, launches, {"mel_frontend": 2})
    n = len(clips)

    def of_scale(a, b) -> float:
        """Max |a - b| over max |a| where a is finite; inf unless both are
        finite at the same places (the silent clips' kurtosis is not)."""
        fin = torch.isfinite(a)
        if not torch.equal(fin, torch.isfinite(b)):
            return float("inf")
        return float((a[fin] - b[fin]).abs().max() / a[fin].abs().max())

    stats_err = {k: of_scale(a, b[:n])
                 for k, a, b in (("char_energy", one[1], two[1]), ("kurtosis", one[2], two[2]))}
    if not (torch.equal(one[0], two[0][:n])
            and max(stats_err.values()) <= CHAR_STATS_OF_SCALE):
        raise AssertionError(f"{phase}: B3 over two shares differs from one launch: log-mel "
                             f"equal {torch.equal(one[0], two[0][:n])}, char stats {stats_err}")
    result = {"clips": n, "launches": launches, "logmel_bit_equal": True,
              "char_stats_of_scale": stats_err, "bound_of_scale": CHAR_STATS_OF_SCALE,
              "one_ms": time_cuda(lambda: extract_features(clips, durs, device=dev,
                                                           max_chars=MAX_CHARS), 3),
              "two_shares_ms": time_cuda(lambda: extract_features(
                  clips, durs, device=dev, max_chars=MAX_CHARS, devices=[dev, dev]), 3)}
    say(phase, card=card, **result)
    return result


def surface_trainer(dev, card: str, cfg, work: pathlib.Path) -> dict:
    """Phase 21 (d): phase 13's trainer resumed with `profile_dir` over three
    steps and a sample synthesis at its last step: the trace holds CUDA
    kernels (its five longest printed), the sample's figure is written, B1
    runs in the sample alone."""
    import dataclasses

    from PIL import Image

    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer
    from visual_onoma_to_wave_tpu_torch.utils import plotting
    from visual_onoma_to_wave_tpu_torch.utils.checkpoint import acoustic_path

    phase = "21d trainer trace and figure"
    start = int(acoustic_path(cfg.path.ckpt).parent.name)
    last = start + 5
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, step=dataclasses.replace(cfg.train.step, synth_step=last)))
    trainer = Trainer(cfg, restore_step=-1, device=dev, profile_dir=str(work / "profile"),
                      profile_steps=(start, start + 3))
    zero_launch_counts()
    trainer.train(max_steps=last)
    torch.cuda.synchronize(dev)
    launches = launch_counts()
    model = trainer.state.model
    expect_launches(phase, launches, {"flash_mha": len(model.encoder.layer_stack)
                                      + len(model.decoder.layer_stack)})
    trace = trainer.profile_trace
    events = json.loads(trace.read_text())["traceEvents"] if trace else []
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: -float(e.get("dur", 0)))
    if not kernels:
        raise AssertionError(f"{phase}: the trace {trace} holds no CUDA kernel")
    longest = [{"name": e["name"][:80], "us": float(e["dur"])} for e in kernels[:5]]
    pngs = sorted((trainer.result_dir / "Val").glob(f"{last}_*.png"))
    if len(pngs) != 1:
        raise AssertionError(f"{phase}: sample figures {pngs}")
    with Image.open(pngs[0]) as im:
        size = im.size
    strip = plotting.STRIP_HEIGHT if cfg.train.use_image else 0
    if size != (plotting.FIG_WIDTH, strip + 2 * plotting.PANEL_HEIGHT):
        raise AssertionError(f"{phase}: figure of {size}")
    print(json.dumps({"phase": phase, "five_longest_device_ops": longest}), flush=True)
    result = {"trace": trace.name, "trace_kernels": len(kernels),
              "trace_kernel_us": sum(float(e["dur"]) for e in kernels),
              "figure": pngs[0].name, "figure_size": list(size), "launches": launches}
    say(phase, card=card, **result)
    return result


def surface_griffin_lim(dev, card: str) -> dict:
    """Phase 21 (e): `griffin_lim` of a 440 Hz tone on the card against the
    CPU from the same initial angles, 30 iterations, with both times."""
    import time

    from visual_onoma_to_wave_tpu_torch.ops.stft import griffin_lim, hann_window
    from visual_onoma_to_wave_tpu_torch.ops.stft import magnitude_spectrogram

    phase = "21e griffin_lim"
    t = np.arange(4 * 1024) / SR
    sig = torch.from_numpy((0.6 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32))
    window = torch.from_numpy(hann_window(MEL_N_FFT))
    mag = magnitude_spectrogram(sig, window, MEL_N_FFT, MEL_HOP, MEL_N_FFT)
    angles = torch.rand(mag.shape, generator=torch.Generator().manual_seed(0)) * 2 * np.pi - np.pi
    t0 = time.perf_counter()
    cpu = griffin_lim(mag, window, MEL_N_FFT, MEL_HOP, n_iters=30, angles=angles)
    cpu_ms = (time.perf_counter() - t0) * 1e3

    def card_call():
        return griffin_lim(mag.to(dev), window.to(dev), MEL_N_FFT, MEL_HOP, n_iters=30,
                           angles=angles.to(dev))

    got = card_call().cpu()
    err = float((got - cpu).abs().max() / cpu.abs().max())
    if not (torch.isfinite(got).all() and err <= GL_OF_SCALE):
        raise AssertionError(f"{phase}: the card off the CPU by {err:.3e} of max")
    result = {"frames": int(mag.shape[1]), "iters": 30, "of_scale": err,
              "bound_of_scale": GL_OF_SCALE, "card_ms": time_cuda(card_call, 5),
              "cpu_ms": cpu_ms}
    say(phase, card=card, **result)
    return result


def phase_surface(dev, card: str, cfg, work: pathlib.Path) -> dict:
    """Phase 21: serving phase 13's checkpoint, serving and B3 over a device
    list, the trainer's trace and figure, griffin_lim (see the docstring)."""
    return {"checkpoint": surface_checkpoint(dev, card, cfg, work),
            "sharded": surface_sharded(dev, card),
            "features": surface_features(dev, card),
            "trainer": surface_trainer(dev, card, cfg, work),
            "griffin_lim": surface_griffin_lim(dev, card)}


def main() -> int:
    probe = phase_probe()
    dev = torch.device("cuda", 0)
    attn = phase_kernel(dev, probe["smi"])
    convnext = phase_convnext(dev, probe["smi"])
    phase_golden(dev)
    full, (_, served) = phase_full(dev, probe["smi"])
    time_attention(dev, attn, "served", served["mel_lens"])   # the decoder's key lengths
    phase_vocos_golden(dev)
    vocos = phase_vocos_full(dev, probe["smi"], full)
    mel = phase_mel(dev, probe["smi"])
    mrf = phase_mrf(dev, probe["smi"])
    phase_golden(dev, "9 istftnet golden", "config_istftnet.json", "vocoder_istftnet_mel.npz",
                 "golden_istftnet.npz", wav_atol=1e-5)
    melrate, _ = phase_full(dev, probe["smi"], "10 istftnet-mel full width", "iSTFTNet-mel",
                            beside=full)
    phase_full(dev, probe["smi"], "10 istftnet c8c8i full width", "iSTFTNet", beside=full)
    phase_full(dev, probe["smi"], "11 melgan full width", "MelGAN", beside=full)
    phase_served(dev, probe["smi"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        train = phase_train(dev, probe["smi"], pathlib.Path(tmp))
        phase_bigvgan(dev, probe["smi"], full)
        phase_chunked(dev, probe["smi"], served["postnet_mel"])
        phase_quality_gate(dev, probe["smi"])
        phase_demo_server(dev, probe["smi"])
        gan = phase_vocoder_training(dev, probe["smi"],
                                     served["postnet_mel"][:CHUNK_B].contiguous(), train["cfg"],
                                     pathlib.Path(tmp))
        phase_export(dev, probe["smi"], pathlib.Path(tmp))
        phase_surface(dev, probe["smi"], train["cfg"], pathlib.Path(tmp))
    phase_scale_out(dev, probe["smi"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as tmp:
        bf16 = phase_bf16(dev, probe["smi"],
                          {"HiFi-GAN": full, "iSTFTNet-mel": melrate, "Vocos": vocos["served"]},
                          {"acoustic": train["step_ms"], "gan": gan["hifigan"]["step_ms_median"]},
                          pathlib.Path(tmp))
    served16 = bf16["served"]

    source = "visual_onoma_to_wave_tpu_torch/csrc/"
    tpu = "visual_onoma_to_wave_tpu/ops/"
    record = {"kernels": [
        {"name": "flash_mha", "route": "cuda", "source": source + "flash_mha.cu",
         "replaces": tpu + "pallas_attention.py:130",
         "launches": full["launches"]["flash_mha"],
         "launches_bf16": served16["HiFi-GAN"]["launches"]["flash_mha"],
         **attention_record(attn)},
        {"name": "convnext_block", "route": "cuda", "source": source + "convnext.cu",
         "replaces": tpu + "pallas_convnext.py:138",
         "launches": vocos["block_launches"],
         "launches_bf16": served16["Vocos"]["launches"]["convnext_block"], **convnext["block"]},
        {"name": "convnext_trunk", "route": "cuda", "source": source + "convnext.cu",
         "replaces": tpu + "pallas_convnext.py:230",
         "launches": vocos["trunk_launches"], **convnext["trunk"]},
        {"name": "mel_frontend", "route": "cuda", "source": source + "mel_frontend.cu",
         "replaces": tpu + "pallas_mel.py:161", **mel},
        {"name": "mrf_stage", "route": "cuda", "source": source + "mrf.cu",
         "replaces": tpu + "pallas_mrf.py:164",
         "launches": melrate["launches"]["mrf_stage"],
         "launches_bf16": served16["iSTFTNet-mel"]["launches"]["mrf_stage"],
         "launches_bf16_hifigan_v1": served16["HiFi-GAN"]["launches"]["mrf_stage"],
         **{k: v for k, v in mrf.items() if k not in ("onepass", "unit")}},
        {"name": "mrf_stage_onepass", "route": "cuda", "source": source + "mrf.cu",
         "replaces": tpu + "pallas_mrf.py:164",
         "launches": served16["HiFi-GAN"]["launches"]["mrf_stage_onepass"], **mrf["onepass"]},
        {"name": "mrf_stage_unit", "route": "cuda", "source": source + "mrf.cu",
         "replaces": tpu + "pallas_mrf.py:164",
         "launches": served16["HiFi-GAN"]["launches"]["mrf_stage_unit"], **mrf["unit"]},
    ]}
    print(probe["smi"])
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
