#!/usr/bin/env python3
"""Where a ConvNeXt tile's time goes inside the kernel (`csrc/convnext.cu`), one GPU.

    python3 tools/convnext_phases.py [--out build/convnext_phases]

Builds a copy of `csrc/convnext.cu` with `clock64()` stamps at a tile's
phase boundaries (depthwise conv, LayerNorm, the M loop of both products,
the epilogue), taken by the first thread of each consumer warpgroup of the
first 8 CTAs, then runs the block kernel at the served shape (B 16, T 1000,
C 512, M 1536) in fp32 and in bf16 and prints one JSON line per type: SM
cycles per phase of one tile (mean over those CTAs and warpgroups), the M
loop's cycles per weight stage, and the bytes of packed weights the M loop
takes per SM cycle. The copy and its library go to `--out`; the port's own
build is not touched. Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from visual_onoma_to_wave_tpu_torch.ops import convnext, cuda_build  # noqa: E402
from visual_onoma_to_wave_tpu_torch.precision import pin_fp32  # noqa: E402

CTAS, STAMPS = 8, 5
PHASES = ("conv", "layernorm", "products", "epilogue")
# (anchor in the source, the stamp placed just before it)
MARKS = (("  // 1a. depthwise conv", 0), ("  // 1b. LayerNorm", 1), ("  float o[NO];", 2),
         ("  // 3. y = x + gamma * (o + b2)", 3), ("\n// The trunk's barrier", 4))


def instrumented(src: str) -> str:
    """The kernel source with the stamps; raises if an anchor moved."""
    head = (f"__device__ long long g_stamps[{2 * CTAS * STAMPS}];\n"
            f"#define STAMP(i) do {{ if (threadIdx.x % 128 == 0 && blockIdx.x < {CTAS}) "
            f"g_stamps[(blockIdx.x * 2 + threadIdx.x / 128) * {STAMPS} + (i)] = clock64(); "
            f"}} while (0)\n")
    src = src.replace("namespace {\n", "namespace {\n" + head, 1)
    for anchor, i in MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"csrc/convnext.cu changed: anchor {anchor!r} not found once")
        if i == 4:   # the end of tile_fwd: the closing brace before the anchor
            at = src.index(anchor)
            end = src.rindex("}", 0, at)
            src = src[:end] + f"  STAMP({i});\n" + src[end:]
        else:
            src = src.replace(anchor, f"  STAMP({i});\n" + anchor, 1)
    return src + ('\nextern "C" int read_stamps(long long* out) { return (int)'
                  'cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps)); }\n')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "convnext_phases"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("convnext_phases: needs an NVIDIA GPU")
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "convnext_stamped.cu").write_text(
        instrumented((cuda_build.CSRC / "convnext.cu").read_text()))
    lib_path = out / "libconvnext_stamped.so"
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(out / "convnext_stamped.cu")], check=True)
    lib = convnext._load_library()   # the port's library: its argtypes, then swapped
    stamped = ctypes.CDLL(str(lib_path))
    for name in ("convnext_block_fwd", "convnext_trunk_fwd"):
        getattr(stamped, name).argtypes = getattr(lib, name).argtypes
        getattr(stamped, name).restype = ctypes.c_int
    cuda_build._libs["convnext"] = stamped

    pin_fp32()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"card": smi.strip()}))
    gen = torch.Generator(device=dev).manual_seed(0)
    B, T, C, M = 16, 1000, 512, 1536
    w = [t[0] for t in chip_smoke.convnext_weights(1, C, M, gen, dev)]
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(B, T, C, generator=gen, device=dev).to(dtype)
        packed = convnext.pack_convnext_weights(w[4], w[6], dtype)
        for _ in range(3):
            convnext.convnext_block(x, *w, packed=packed)
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (2 * CTAS * STAMPS))()
        cuda_build.check_launch("read_stamps", stamped.read_stamps(ctypes.addressof(buf)))
        rows = [buf[k * STAMPS:(k + 1) * STAMPS] for k in range(2 * CTAS)]
        cycles = {p: sum(r[i + 1] - r[i] for r in rows) / len(rows) for i, p in enumerate(PHASES)}
        stage_bytes = 32768 if dtype == torch.float32 else 16384
        stages = packed.numel() * packed.element_size() // stage_bytes
        print(json.dumps({
            "dtype": str(dtype).split(".")[-1], "shape": f"B={B} T={T} C={C} M={M}",
            "cycles_per_tile": {**cycles, "total": sum(cycles.values())},
            "weight_stages_per_tile": stages,
            "products_cycles_per_stage": cycles["products"] / stages,
            "weight_bytes_per_sm_cycle": stages * stage_bytes / cycles["products"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
