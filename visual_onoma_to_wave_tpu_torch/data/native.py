"""The host C kernels of the data plane (`csrc/datakernels.c`, a copy of the
JAX package's `native/datakernels.c`), loaded with ctypes.

    native.available()                       # built (or buildable) here
    cells = native.pad_cells_u8(img, widths, cell_width)
    path_i, path_j = native.dtw_path_f64(cost)

The library is compiled from the source at first use with the host's C
compiler (`cc -O2 -shared -fPIC`) into `build/native/<hash>/` at the
repository root (gitignored; the hash covers the source), written under a
temporary name and renamed, so that loader workers starting together do not
see a half-written file. Each function equals its numpy twin bit for bit
(`data/dataset.py::pad_character_cells`, `metrics.py::dtw_path`; the same
moves and tie-breaking): the callers take the numpy twin only where no C
compiler is found. The source's `fill_cells_f32` has no caller here, as in
the JAX package. `tools/host_kernels_timing.py` measured why the port
carries them: the numpy DTW took 9.7% of one `evaluate(metrics=True)`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "datakernels.c"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "native"
CFLAGS = ["-O2", "-shared", "-fPIC"]

_LIB = None
_TRIED = False


def library_path() -> pathlib.Path:
    key = hashlib.sha256(SRC.read_bytes() + " ".join(CFLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / key / "libdatakernels.so"


def _build() -> pathlib.Path | None:
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f".{so.name}.{os.getpid()}")
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run([cc, *CFLAGS, str(SRC), "-o", str(tmp)], check=True,
                           capture_output=True, timeout=120)
        except (FileNotFoundError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
            continue
        os.replace(tmp, so)
        return so
    return None


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(str(so))
    lib.pad_cells_u8.restype = ctypes.c_int
    lib.pad_cells_u8.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.dtw_path_f64.restype = ctypes.c_int64
    lib.dtw_path_f64.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    """True when the library is built or a C compiler built it now."""
    return _load() is not None


def pad_cells_u8(img: np.ndarray, widths: np.ndarray, cell_width: int) -> np.ndarray:
    """(H, W) uint8 strip -> (n, H, cell_width) uint8 cells, each character
    centred on 255 with the extra pixel on the left (`pad_character_cells`)."""
    img = np.ascontiguousarray(img, np.uint8)
    widths = np.ascontiguousarray(widths, np.int64)
    h, w = img.shape
    out = np.empty((widths.shape[0], h, cell_width), np.uint8)
    _load().pad_cells_u8(img.ctypes.data, h, w, widths.ctypes.data, widths.shape[0],
                         cell_width, out.ctypes.data)
    return out


def dtw_path_f64(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The DTW alignment path over a (T1, T2) float64 cost matrix
    (`metrics.dtw_path`'s moves and tie-breaking): (path_i, path_j) int64."""
    cost = np.ascontiguousarray(cost, np.float64)
    t1, t2 = cost.shape
    acc = np.empty((t1 + 1) * (t2 + 1), np.float64)
    pi, pj = np.empty(t1 + t2, np.int64), np.empty(t1 + t2, np.int64)
    k = _load().dtw_path_f64(cost.ctypes.data, t1, t2, acc.ctypes.data, pi.ctypes.data,
                             pj.ctypes.data)
    if k < 0:
        raise ValueError(f"degenerate DTW cost shape {cost.shape}")
    return pi[:k].copy(), pj[:k].copy()
