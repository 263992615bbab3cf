"""The one-pass design of the MRF stage kernel (`csrc/mrf.cu`, B2 in bf16;
built for C 8-64, routed at C 8-32), on the CPU.

`emulated_onepass` repeats the kernel's arithmetic in plain PyTorch: frame
tiles of `onepass_tile_frames(C)` output frames, each with a 64-frame halo on
both sides (the stage reaches 60); per branch y = x (bf16) in fp32 and the
conv inputs bf16(leaky_relu(.)); each conv computes as few 64-row tiles
(wgmma's M) as cover the rows that the convs after it need, centred on them,
the needed range shrinking by each conv's reach down to the output tiles; a tap reads its input at a row offset
(j - (k-1)/2) * d inside one window with 32 margin rows; per 32-channel chunk
and group of up to 4 taps (K <= 128) one fresh tensor-core sum, taken as the
exact sum of the bf16 products rounded once to fp32, added to the tile's fp32
accumulator in chunk and group order; + bias, zero outside [0, T); conv1
writes h, conv2 y += h; the branch sum ((y_0 + y_1) + y_2) / 3 rounded to
bf16 once. The weights are the kernel's bf16 stream (`pack_mrf_kernel_weights`),
undone.

Held here at C 8 / 16 / 32 / 64 and T 20 (inside the halo), one tile less
one frame, one tile, one tile and one frame, and 1000, B 1, against the TPU
kernel `mrf_stage_fused(..., dtype=bfloat16, interpret=True)` and against
`mrf_stage_fused_reference` (the fp32 `F.conv1d` chain on bf16 operands):
at most 2e-2 of the elements differ, each by at most ONE bf16 ulp of
max(|ref|, max |ref| / 8). Why: the sums are taken in other orders, so now
and then a conv input's bf16 rounding flips; the later convs carry the flip
as a fraction of an ulp into many outputs, and the final rounding moves some
of them by one ulp (an output near 0 by one ulp of larger values). The TPU
kernel and the plain chain, both faithful, differ from each other in up to
8.7e-3 of the elements (C 64 T 127); the emulation measured at most 1.02e-2
and one ulp.

The tiles meet without a seam: one tile spanning all of T gives the same
numbers bit for bit. One tile spanning T computes every frame once, in the
conv chain's grouping and order, so the one-pass design and the chain
design (the chain's bf16 kernel) compute the same numbers.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from visual_onoma_to_wave_tpu.ops import pallas_mrf
from visual_onoma_to_wave_tpu_torch.ops.mrf import (
    ONEPASS_KERNEL_WIDTHS,
    ONEPASS_WIDTHS,
    kernel_tile,
    mrf_route,
    mrf_stage_fused_reference,
    mrf_stage_onepass,
    onepass_takes,
    onepass_tile_frames,
    pack_mrf_kernel_weights,
)

KS = (3, 7, 11)
DS = ((1, 3, 5),) * 3
HALO, MARGIN, GROUP = 64, 32, 4     # csrc/mrf.cu: OP_HALO, OP_MARGIN, GROUP_MAX
DIFFER_SHARE, ULPS = 2e-2, 1.0


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _kernel_taps(packed: torch.Tensor, C: int, k: int) -> torch.Tensor:
    """One branch's packed bf16 stream as weights [conv, j, ci, co]."""
    _, kc, kcp = kernel_tile(C, torch.bfloat16)
    planes = packed.float().reshape(6, C // kc, k, kcp // 8, C // 8, 8, 8)
    # [conv, chunk, j, K group, N core, row, 8] -> [conv, j, chunk, ci, co]
    w = planes.permute(0, 2, 1, 3, 6, 4, 5).reshape(6, k, C // kc, kcp, C)
    return w[:, :, :, :kc].reshape(6, k, C, C)


def _reach(p: int, dilations) -> list[int]:
    """Each conv's one-sided reach past the output frames that the convs
    after it need (the kernel's `ext`)."""
    ext, reach = [0] * 6, 0
    for i in range(2, -1, -1):
        ext[2 * i + 1] = reach
        reach += p
        ext[2 * i] = reach
        reach += p * dilations[i]
    return ext


def emulated_onepass(x: torch.Tensor, mats, biases: torch.Tensor, m_out: int | None = None,
                     kernel_sizes=KS, dilations=DS) -> torch.Tensor:
    """The one-pass kernel's stage on x (B, C, T) -> (B, C, T) bf16; `mats`
    and `biases` from `pack_mrf_weights`; `m_out` output frames a tile
    (a multiple of 64; default `onepass_tile_frames(C)`). Every frame tile
    of every item is one row of a batch."""
    B, C, T = x.shape
    m_out = m_out or onepass_tile_frames(C)
    W = m_out + 2 * HALO
    kc = kernel_tile(C, torch.bfloat16)[1]
    bias = biases.reshape(18, C).float()
    tiles = -(-T // m_out)
    xp = F.pad(_bf16(x), (HALO, tiles * m_out - T + HALO))
    window = xp.unfold(2, W, m_out).permute(0, 2, 3, 1).reshape(B * tiles, W, C)
    frame = (torch.arange(tiles)[:, None] * m_out - HALO + torch.arange(W)[None]).repeat(B, 1)
    valid = ((frame >= 0) & (frame < T))[..., None]
    total = None
    streams = pack_mrf_kernel_weights(mats, torch.bfloat16)
    for b, (packed, k, ds) in enumerate(zip(streams, kernel_sizes, dilations)):
        w, p = _kernel_taps(packed, C, k), (k - 1) // 2
        ext = _reach(p, ds)
        y = window.clone()
        xin = F.pad(_bf16(F.leaky_relu(y, 0.1)), (0, 0, MARGIN, MARGIN))
        hin = torch.zeros_like(xin)
        for conv in range(6):
            first = conv % 2 == 0
            d = ds[conv // 2] if first else 1
            # as few 64-row tiles as cover the rows the later convs need,
            # centred on them
            c2 = -(-2 * ext[conv] // 64)
            lo = HALO - 32 * c2
            hi = lo + 64 * (m_out // 64 + c2)
            src = xin if first else hin
            acc = torch.zeros(src.shape[0], hi - lo, C)
            for c0 in range(0, C, kc):
                for j0 in range(0, k, GROUP):
                    js = range(j0, min(j0 + GROUP, k))
                    a = torch.cat([src[:, MARGIN + lo + (j - p) * d:MARGIN + hi + (j - p) * d,
                                       c0:c0 + kc] for j in js], -1)
                    bw = torch.cat([w[conv, j, c0:c0 + kc] for j in js], 0)
                    acc = acc + (a.double() @ bw.double()).float()
            v = torch.where(valid[:, lo:hi], acc + bias[6 * b + conv], torch.zeros(()))
            if first:
                hin[:, MARGIN + lo:MARGIN + hi] = _bf16(F.leaky_relu(v, 0.1))
            else:
                y[:, lo:hi] = y[:, lo:hi] + v
                xin[:, MARGIN + lo:MARGIN + hi] = _bf16(F.leaky_relu(y[:, lo:hi], 0.1))
        out = y[:, HALO:HALO + m_out]
        total = out if total is None else total + out
    result = (total / 3).to(torch.bfloat16)
    return result.reshape(B, tiles * m_out, C)[:, :T].transpose(1, 2)


def _stage_tree(rng, C: int) -> dict:
    """A flax stage tree at chip_smoke.mrf_weights's scale (every residual
    stream O(1))."""
    stage = {}
    for j, k in enumerate(KS):
        p = {}
        for i in range(3):
            for nm in ("convs1", "convs2"):
                p[f"{nm}_{i}_w"] = rng.normal(0, 0.5 / np.sqrt(k * C), (k, C, C)).astype(np.float32)
                p[f"{nm}_{i}_b"] = rng.normal(0, 0.1, (C,)).astype(np.float32)
        stage[f"resblock_{j}"] = p
    return stage


def _case(C: int, T: int) -> dict:
    rng = np.random.default_rng(1000 * C + T)
    x = rng.normal(0, 1, (1, C, T)).astype(np.float32)
    (w3, w7, w11), bias = pallas_mrf.pack_mrf_weights(_stage_tree(rng, C), KS, DS)
    tpu = pallas_mrf.mrf_stage_fused(jnp.asarray(x), w3, w7, w11, bias, t_tile=256,
                                     dtype=jnp.bfloat16, interpret=True)
    mats = [torch.from_numpy(np.asarray(a)) for a in (w3, w7, w11)]
    biases, xt = torch.from_numpy(np.asarray(bias)), torch.from_numpy(x)
    return {"x": xt, "mats": mats, "biases": biases,
            "jax": torch.from_numpy(np.asarray(tpu).astype(np.float32)),
            "plain": mrf_stage_fused_reference(xt, *mats, biases, dtype=torch.bfloat16).float(),
            "emulated": emulated_onepass(xt, mats, biases).float()}


def _cases():
    out = []
    for C in ONEPASS_KERNEL_WIDTHS:
        tile = onepass_tile_frames(C)
        out += [(C, T) for T in (20, tile - 1, tile, tile + 1, 1000)]
    return out


def _ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each |v| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.parametrize("C,T", _cases(), ids=[f"C{c}-T{t}" for c, t in _cases()])
def test_the_tile_walk_rounds_where_the_tpu_kernel_does(C, T):
    case = _case(C, T)
    got = case["emulated"]
    assert got.shape == (1, C, T) and bool(torch.isfinite(got).all())
    for name in ("jax", "plain"):
        ref = case[name]
        floor = torch.maximum(ref.abs(), ref.abs().max() / 8)
        differ = (got != ref).float().mean().item()
        ulps = ((got - ref).abs() / _ulp(floor)).max().item()
        assert differ <= DIFFER_SHARE and ulps <= ULPS, (name, differ, ulps)


@pytest.mark.parametrize("C", ONEPASS_KERNEL_WIDTHS)
def test_tiles_meet_without_a_seam(C):
    """The kernel's tiles, and 64-frame tiles, against one tile spanning all
    of T: bit for bit."""
    rng = np.random.default_rng(C)
    T = 2 * onepass_tile_frames(C) + 37
    x = torch.from_numpy(rng.normal(0, 1, (2, C, T)).astype(np.float32))
    (w3, w7, w11), bias = pallas_mrf.pack_mrf_weights(_stage_tree(rng, C), KS, DS)
    mats = [torch.from_numpy(np.asarray(a)) for a in (w3, w7, w11)]
    biases = torch.from_numpy(np.asarray(bias))
    whole = emulated_onepass(x, mats, biases, m_out=64 * -(-T // 64))
    assert torch.equal(emulated_onepass(x, mats, biases), whole)
    assert torch.equal(emulated_onepass(x, mats, biases, m_out=64), whole)


@pytest.mark.parametrize("C", (8, 16, 32, 64, 128, 256, 512))
def test_the_route_sends_bf16_at_c_up_to_32_to_the_one_pass_kernel(C):
    """bf16 at C 8-32 takes the one-pass kernel; at C 64 it is built but the
    conv chain runs faster, and the unit design faster still, so the route
    sends C 64 there; C >= 128 keeps the chain, as fp32 does at every width
    (the width alone: a stage of the served size)."""
    want = "onepass" if C <= 32 else "unit" if C == 64 else "chain"
    assert mrf_route(C, torch.bfloat16) == want
    assert mrf_route(C, torch.float32) == "chain"
    assert mrf_route(C, torch.bfloat16, KS, DS) == mrf_route(C, torch.bfloat16)
    assert onepass_takes(C, torch.bfloat16) == (C <= 64)
    assert not onepass_takes(C, torch.float32)


def test_the_route_keeps_stages_that_reach_further_on_the_chain():
    """The one-pass windows take a stage reaching 64 frames and a conv
    reaching 32 (the margin rows); the default stage reaches 60 and 25."""
    assert pallas_mrf.stage_halo(KS, DS) == 60
    assert mrf_route(32, torch.bfloat16, (1, 5, 9), ((1, 1, 1), (2, 4, 8), (3, 3, 3))) == "onepass"
    assert mrf_route(32, torch.bfloat16, (3, 3, 11), ((123, 1, 1), (1, 1, 1), (2, 2, 2))) == "chain"
    assert mrf_route(32, torch.bfloat16, (3, 3, 3), ((1, 1, 58), (1, 1, 1), (1, 1, 1))) == "chain"
    assert mrf_route(32, torch.bfloat16, (3, 7, 11), ((1, 3, 5), (1, 3, 5), (1, 3, 7))) == "chain"
    assert mrf_route(32, torch.bfloat16, (3, 7, 9), ((1, 3, 5),) * 3) == "onepass"
    assert set(ONEPASS_WIDTHS) < set(ONEPASS_KERNEL_WIDTHS)
    for C in ONEPASS_KERNEL_WIDTHS:
        assert onepass_tile_frames(C) % 64 == 0 and onepass_tile_frames(C) >= 64


def test_the_one_pass_launch_refuses_other_operands_and_the_cpu():
    """What the route does not send to the one-pass kernel raises there, and
    so does a tensor off the card (checked last)."""
    g = torch.Generator().manual_seed(0)
    mats = [torch.randn(6, 32, k * 32, generator=g) for k in KS]
    packed = pack_mrf_kernel_weights(mats, torch.bfloat16)
    bias = torch.zeros(18, 32, 1)
    x = torch.randn(1, 32, 50, generator=g).to(torch.bfloat16)
    before = mrf_stage_onepass.launches
    with pytest.raises(ValueError, match="contiguous bf16"):
        mrf_stage_onepass(x.float(), packed, bias)
    with pytest.raises(ValueError, match="C in"):
        mrf_stage_onepass(torch.zeros(1, 128, 50, dtype=torch.bfloat16), packed, bias)
    with pytest.raises(ValueError, match="reach"):
        mrf_stage_onepass(x, packed, bias, dilations=((9, 9, 9),) * 3)
    with pytest.raises(ValueError, match="unsupported device"):
        mrf_stage_onepass(x, packed, bias)
    assert mrf_stage_onepass.launches == before
