"""Why the MRF stage kernel (`csrc/mrf.cu`, B2) runs fp32 as 3xTF32, and why
its time tiles meet exactly, on the CPU.

`emulated_stage` repeats the kernel's arithmetic in plain PyTorch: x taken
channels-last; each conv walks time tiles of `tile_frames(C)` frames; a
tile's input window (its frames plus the conv's halo, zero outside [0, T))
is staged once per chunk of 16 input channels with the leaky ReLU applied
and split into hi = `tf32_round(v)` and the exact remainder lo; each tap j
reads the window at row offset j * d (the kernel's descriptor offset), and
each (chunk, tap) is one fresh tensor-core sum over its 16 channels (fp32:
`GROUP` taps a sum), with every operand as the tensor cores read it (TF32:
lo truncated) and fp32 sums, added to the tile's fp32 accumulator; conv1 writes h = acc + bias,
conv2 y = y + (acc + bias); the branches are averaged as
((y_0 + y_1) + y_2) / 3. The weights come from `pack_mrf_kernel_weights`,
undone. Products are taken one channel at a time with separate IEEE
multiplies and adds, so a frame's result does not depend on which tile
holds it.

Held here, at C 32 (T 700: two 512-frame tiles) and C 64 (T 600: three
256-frame tiles), B 2, against the TPU kernel `mrf_stage_fused` in interpret
mode and against `mrf_stage_fused_reference` (the fp32 `F.conv1d` chain):
  * 3xTF32 (hi*lo + lo*hi + hi*hi) lands within chip_smoke's 1e-5 x max
    |plain| fp32 bound of both (1.1e-7 to 2.2e-7 of max |plain|); one TF32
    product (hi*hi) misses it, at 5.5e-5 (C 32) and 6.1e-5 (C 64);
  * the tiled result equals one tile spanning all of T bit for bit: no seam.
The kernel has no recompute: conv1's output h goes through device memory,
so every frame of every conv is computed once, by the tile that owns it.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from visual_onoma_to_wave_tpu.ops import pallas_mrf
from visual_onoma_to_wave_tpu_torch.ops.convnext import tf32_round
from visual_onoma_to_wave_tpu_torch.ops.mrf import (
    kernel_tile,
    mrf_stage_fused_reference,
    pack_mrf_kernel_weights,
    tile_frames,
)

KS = (3, 7, 11)
DS = ((1, 3, 5),) * 3
BOUND = chip_smoke.MRF_OF_SCALE[torch.float32]
GROUP = 1     # fp32 taps of one chunk in one fresh tensor-core sum (csrc/mrf.cu)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an fp32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) as the tensor cores read them: hi = tf32 round to nearest,
    lo = the exact remainder truncated to TF32."""
    hi = tf32_round(v)
    return hi, _tf32_trunc(v - hi)


def _kernel_taps(packed: torch.Tensor, C: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One branch's packed fp32 stream as (hi, lo) weights [conv, j, ci, co]
    (lo truncated as the tensor cores read it)."""
    nt, kc, kcp = kernel_tile(C, torch.float32)
    planes = packed.reshape(6, C // nt, C // kc, k, 2, kcp // 4, nt // 8, 8, 4)
    # [conv, co tile, ci chunk, j, split, K group, N core, row, 4] -> [.., co, ci]
    w = planes.permute(0, 4, 3, 2, 5, 8, 1, 6, 7).reshape(6, 2, k, C, C)
    return w[:, 0], _tf32_trunc(w[:, 1])


def _tensor_core_sum(out, a_hi, a_lo, b_hi, b_lo, three: bool) -> torch.Tensor:
    """`out` + a (B, M, KC) against b (KC, N) inside one tensor-core sum: per
    k-step of 8 channels hi*lo, lo*hi, hi*hi (3xTF32) or hi*hi alone."""
    for s in range(0, a_hi.shape[2], 8):
        pairs = ((a_hi, b_lo), (a_lo, b_hi), (a_hi, b_hi)) if three else ((a_hi, b_hi),)
        for a, b in pairs:
            for c in range(s, s + 8):
                out = out + a[:, :, c:c + 1] * b[c]
    return out


def emulated_conv(inp, w_hi, w_lo, bias, k: int, d: int, tile: int, three: bool,
                  res=None) -> torch.Tensor:
    """One conv of the kernel on channels-last fp32 `inp` (B, T, C), before
    the leaky ReLU: time tiles of `tile` frames, taps as row offsets into the
    tile's staged window, a fresh sum per 16-channel chunk and group of
    GROUP taps."""
    B, T, C = inp.shape
    kc = kernel_tile(C, torch.float32)[1]
    pad = (k - 1) // 2 * d
    act = torch.nn.functional.leaky_relu(inp, 0.1)
    out = torch.empty(B, T, C)
    for t0 in range(0, T, tile):
        window = torch.zeros(B, tile + 2 * pad, C)
        lo_t, hi_t = max(t0 - pad, 0), min(t0 + tile + pad, T)
        window[:, lo_t - (t0 - pad):hi_t - (t0 - pad)] = act[:, lo_t:hi_t]
        win_hi, win_lo = _split(window)
        acc = torch.zeros(B, tile, C)
        for c0 in range(0, C, kc):
            for j0 in range(0, k, GROUP):
                fresh = torch.zeros(B, tile, C)
                for j in range(j0, min(j0 + GROUP, k)):
                    rows = slice(j * d, j * d + tile)
                    fresh = _tensor_core_sum(fresh, win_hi[:, rows, c0:c0 + kc],
                                             win_lo[:, rows, c0:c0 + kc], w_hi[j, c0:c0 + kc],
                                             w_lo[j, c0:c0 + kc], three)
                acc = acc + fresh
        v = acc + bias
        n = min(tile, T - t0)
        out[:, t0:t0 + n] = v[:, :n] if res is None else res[:, t0:t0 + n] + v[:, :n]
    return out


def emulated_stage(x: torch.Tensor, mats, biases: torch.Tensor, three: bool = True,
                   tile: int | None = None) -> torch.Tensor:
    """The kernel's fp32 stage on x (B, C, T); `mats` and `biases` from
    `pack_mrf_weights`; `tile` defaults to the kernel's `tile_frames(C)`."""
    C = x.shape[1]
    tile = tile or tile_frames(C)
    bias = biases.reshape(18, C)
    xt = x.transpose(1, 2).contiguous()
    acc = None
    for b, (packed, k, ds) in enumerate(zip(pack_mrf_kernel_weights(mats), KS, DS)):
        w_hi, w_lo = _kernel_taps(packed, C, k)
        y = xt
        for i, d in enumerate(ds):
            h = emulated_conv(y, w_hi[2 * i], w_lo[2 * i], bias[6 * b + 2 * i], k, d, tile, three)
            y = emulated_conv(h, w_hi[2 * i + 1], w_lo[2 * i + 1], bias[6 * b + 2 * i + 1], k, 1,
                              tile, three, res=y)
        acc = y if acc is None else acc + y
    return (acc / 3).transpose(1, 2)


def _stage_tree(rng, C: int) -> dict:
    """A flax stage tree (tests/test_pallas_mrf.py's layout) at a scale that
    keeps the residual streams O(1), as chip_smoke.mrf_weights does."""
    stage = {}
    for j, k in enumerate(KS):
        p = {}
        for i in range(3):
            for nm in ("convs1", "convs2"):
                p[f"{nm}_{i}_w"] = rng.normal(0, 0.5 / np.sqrt(k * C), (k, C, C)).astype(np.float32)
                p[f"{nm}_{i}_b"] = rng.normal(0, 0.1, (C,)).astype(np.float32)
        stage[f"resblock_{j}"] = p
    return stage


@pytest.fixture(scope="module", params=[(32, 700), (64, 600)], ids=["C32-T700", "C64-T600"])
def stage(request):
    C, T = request.param
    rng = np.random.default_rng(C)
    x = rng.normal(0, 1, (2, C, T)).astype(np.float32)
    (w3, w7, w11), bias = pallas_mrf.pack_mrf_weights(_stage_tree(rng, C), KS, DS)
    jax_kernel = np.asarray(pallas_mrf.mrf_stage_fused(
        jnp.asarray(x), w3, w7, w11, bias, t_tile=256, dtype=jnp.float32, interpret=True))
    mats = [torch.from_numpy(np.asarray(a)) for a in (w3, w7, w11)]
    biases = torch.from_numpy(np.asarray(bias))
    xt = torch.from_numpy(x)
    return {"x": xt, "mats": mats, "biases": biases, "jax": torch.from_numpy(jax_kernel.copy()),
            "plain": mrf_stage_fused_reference(xt, *mats, biases),
            "three": emulated_stage(xt, mats, biases)}


def _of_scale(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got - ref).abs().max() / ref.abs().max()).item()


def test_3xtf32_holds_the_fp32_bound_against_the_jax_kernel_and_the_plain_chain(stage):
    assert stage["x"].shape[2] > tile_frames(stage["x"].shape[1])   # at least two tiles
    for ref in ("jax", "plain"):
        assert _of_scale(stage["three"], stage[ref]) <= BOUND, ref


def test_one_tf32_product_misses_the_fp32_bound(stage):
    one = emulated_stage(stage["x"], stage["mats"], stage["biases"], three=False)
    for ref in ("jax", "plain"):
        assert _of_scale(one, stage[ref]) > 4 * BOUND, ref
        assert _of_scale(one, stage[ref]) > 100 * _of_scale(stage["three"], stage[ref])


def test_time_tiles_meet_without_a_seam(stage):
    """The kernel's tiles against one tile spanning all of T: bit-equal."""
    whole = emulated_stage(stage["x"], stage["mats"], stage["biases"],
                           tile=stage["x"].shape[2])
    assert torch.equal(stage["three"], whole)
