"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Every source is compiled the same way: `nvcc` for sm_90a into a shared
library with a plain C interface, under `build/kernels/<hash>/` at the
repository root (gitignored), where the hash covers the source and the
flags, with ptxas's register and spill report (`ptxas.log`) beside the
`.so`. The library is built at first use and loaded with ctypes. A failed
build raises; nothing falls back to another implementation.

    lib = load_library("convnext", {"convnext_block_fwd": [...argtypes]})

`build_libraries()` compiles several sources at once, one nvcc process
each, all started together (`chip_smoke.py` builds every kernel that way
before its first phase).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("flash_mha", "convnext", "mel_frontend", "mrf")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda); "
                           "the CUDA kernels are built from source at first use")
    return nvcc


def library_path(name: str) -> pathlib.Path:
    """Where `csrc/<name>.cu` builds to (keyed by a hash of source + flags)."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / key / f"lib{name}.so"


def build_libraries(names=SOURCES) -> dict[str, pathlib.Path]:
    """Compile the named sources that are not built yet, in parallel; raise
    on any failed build. Returns {name: path of the .so}."""
    outs = {n: library_path(n) for n in names}
    procs = {}
    for name, out in outs.items():
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{stdout}\n{stderr}")
            continue
        (outs[name].parent / "ptxas.log").write_text(stdout + stderr)
        os.replace(tmp, outs[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load_library(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`; every entry point in
    `signatures` gets its argtypes and an int (cudaError_t) restype."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build_libraries((name,))[name]))
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def check_launch(kernel: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error (0 = launched)."""
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


def check_inference(kernel: str, *tensors) -> None:
    """The kernels have no backward: raise rather than hand autograd an
    output that is silently cut off from its inputs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} kernel is inference-only (no backward): call it under "
                           f"torch.no_grad() or torch.inference_mode()")
