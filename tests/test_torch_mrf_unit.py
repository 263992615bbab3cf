"""The unit design of the MRF stage kernel (`csrc/mrf.cu`, B2 in bf16; built
for C 64-256, routed at C 64), and the size rule of `mrf_route`, on the CPU.

`emulated_unit` repeats the design's arithmetic in plain PyTorch: per
dilation one residual unit of every branch, over frame tiles of
`unit_tile_frames(C)` output frames; a tile stages X = bf16(leaky_relu(y))
over its frames and 64 more on each side (zero outside [0, T)); conv1
computes the tile's frames and 32 more on each side from X (a tap reads X at
a row offset (j - (k-1)/2) * d), writes H = bf16(leaky_relu(conv + bias)),
zero outside [0, T); conv2 computes the tile's frames from H and adds them
with its bias to the fp32 residual stream y; per 32-channel chunk and group
of up to 4 taps one fresh tensor-core sum (the exact sum of the bf16
products rounded once to fp32) added to the fp32 accumulator in chunk and
group order; the branch sum ((y_0 + y_1) + y_2) / 3 rounded to bf16 once.
The weights are the kernel's bf16 stream (`pack_mrf_kernel_weights`),
undone.

Held here at C 64 / 128 / 256 and T inside one tile, one tile less one
frame, one tile, one tile and one frame and a few tiles, B 1 and 2, against
the TPU kernel `mrf_stage_fused(..., dtype=bfloat16, interpret=True)`: each
element within one bf16 ulp of max(|ref|, max |ref| / 8), and at most 2e-2
of the elements differing beyond the share by which the plain version
(`mrf_stage_fused_reference`, the fp32 `F.conv1d` chain on bf16 operands)
differs from the TPU kernel on the same draw. Why that share: the sums are
taken in other orders, so now and then a conv input's bf16 rounding flips
and the later convs carry it into many outputs, each by a fraction of an ulp
(tests/test_torch_mrf_onepass.py); the deeper the sum (K = k C), the more
flips. Two faithful implementations, the plain version and the TPU kernel,
differ in up to 2.7e-2 of the elements at C 64 T 191 and 2.2e-2 at C 128
on random draws, so a fixed 2e-2 would fail the plain version itself; a
conv input rounded at another point moves tens of percent of them. The
tiles meet bit for bit (one tile spanning T, and 64-frame tiles, give the
same numbers), and the design keeps the conv chain's grouping: its
emulation equals `emulated_chain` (every conv over the whole of T at once)
bit for bit.
"""
from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from visual_onoma_to_wave_tpu.ops import pallas_mrf
from visual_onoma_to_wave_tpu_torch.ops.mrf import (
    MIN_ITEMS_PER_SM,
    SMS,
    UNIT_KERNEL_WIDTHS,
    UNIT_WIDTHS,
    design_items,
    kernel_tile,
    mrf_route,
    mrf_stage_fused_reference,
    mrf_stage_unit,
    pack_mrf_kernel_weights,
    unit_takes,
    unit_tile_frames,
)

KS = (3, 7, 11)
DS = ((1, 3, 5),) * 3
MARGIN, HALO, GROUP = 32, 32, 4     # csrc/mrf.cu: UNIT_MARGIN, conv2's reach, GROUP_MAX
DIFFER_SHARE, ULPS = 2e-2, 1.0


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _kernel_taps(packed: torch.Tensor, C: int, k: int) -> torch.Tensor:
    """One branch's packed bf16 stream as weights [conv, j, ci, co]."""
    nt, kc, kcp = kernel_tile(C, torch.bfloat16)
    planes = packed.float().reshape(6, C // nt, C // kc, k, kcp // 8, nt // 8, 8, 8)
    # [conv, co tile, chunk, j, K group, N core, row, 8] -> [conv, j, chunk, ci, co]
    w = planes.permute(0, 3, 2, 4, 7, 1, 5, 6).reshape(6, k, C // kc, kcp, C)
    return w[:, :, :, :kc].reshape(6, k, C, C)


def _grouped(src: torch.Tensor, rows: int, offsets, w: torch.Tensor, C: int) -> torch.Tensor:
    """sum_j src[:, o_j : o_j + rows] @ w[j] in the kernel's grouping: per
    32-channel chunk and group of up to 4 taps one exact sum rounded once to
    fp32, added in chunk and group order. src (N, R, C); w (k, C, C)."""
    k = len(offsets)
    acc = torch.zeros(src.shape[0], rows, C)
    for c0 in range(0, C, 32):
        for j0 in range(0, k, GROUP):
            js = range(j0, min(j0 + GROUP, k))
            a = torch.cat([src[:, offsets[j]:offsets[j] + rows, c0:c0 + 32] for j in js], -1)
            bw = torch.cat([w[j, c0:c0 + 32] for j in js], 0)
            acc = acc + (a.double() @ bw.double()).float()
    return acc


def _branch_weights(mats, C: int):
    return [_kernel_taps(p, C, k) for p, k in
            zip(pack_mrf_kernel_weights(mats, torch.bfloat16), KS)]


def emulated_unit(x: torch.Tensor, mats, biases: torch.Tensor, m_out: int | None = None
                  ) -> torch.Tensor:
    """The unit design's stage on x (B, C, T) -> (B, C, T) bf16; `mats` and
    `biases` from `pack_mrf_weights`; `m_out` output frames a tile (a
    multiple of 64; default `unit_tile_frames(C)`)."""
    B, C, T = x.shape
    m = m_out or unit_tile_frames(C)
    tiles = -(-T // m)
    bias = biases.reshape(18, C).float()
    frame0 = torch.arange(tiles)[:, None] * m           # each tile's first output frame
    total = None
    for b, (w, k, ds) in enumerate(zip(_branch_weights(mats, C), KS, DS)):
        p = (k - 1) // 2
        y = _bf16(x).transpose(1, 2)                    # (B, T, C) fp32 residual stream
        for i, d in enumerate(ds):
            # X over frames [t0 - 64, t0 + m + 64) of every tile, zero outside [0, T)
            yp = F.pad(y, (0, 0, HALO + MARGIN, tiles * m - T + HALO + MARGIN))
            xw = _bf16(F.leaky_relu(yp, 0.1)).unfold(1, m + 2 * (HALO + MARGIN), m)
            xw = xw.permute(0, 1, 3, 2).reshape(B * tiles, -1, C)
            # conv1 over frames [t0 - 32, t0 + m + 32)
            f1 = (frame0 - HALO + torch.arange(m + 2 * HALO)[None]).repeat(B, 1)[..., None]
            h = _grouped(xw, m + 2 * HALO, [MARGIN + (j - p) * d for j in range(k)],
                         w[2 * i], C)
            h = torch.where((f1 >= 0) & (f1 < T), h + bias[6 * b + 2 * i], torch.zeros(()))
            hw = _bf16(F.leaky_relu(h, 0.1))
            # conv2 over the tile's frames, added to the residual stream
            v = _grouped(hw, m, [HALO + j - p for j in range(k)], w[2 * i + 1], C)
            v = (v + bias[6 * b + 2 * i + 1]).reshape(B, tiles * m, C)[:, :T]
            y = y + v
        total = y if total is None else total + y
    return (total / 3).to(torch.bfloat16).transpose(1, 2)


def emulated_chain(x: torch.Tensor, mats, biases: torch.Tensor) -> torch.Tensor:
    """The conv chain's bf16 stage in the same grouping, every conv over the
    whole of T at once: (B, C, T) -> (B, C, T) bf16."""
    B, C, T = x.shape
    bias = biases.reshape(18, C).float()
    total = None
    for b, (w, k, ds) in enumerate(zip(_branch_weights(mats, C), KS, DS)):
        p = (k - 1) // 2
        y = _bf16(x).transpose(1, 2)
        for i, d in enumerate(ds):
            xin = F.pad(_bf16(F.leaky_relu(y, 0.1)), (0, 0, p * d, p * d))
            h = _grouped(xin, T, [j * d for j in range(k)], w[2 * i], C) + bias[6 * b + 2 * i]
            hin = F.pad(_bf16(F.leaky_relu(h, 0.1)), (0, 0, p, p))
            y = y + (_grouped(hin, T, list(range(k)), w[2 * i + 1], C) +
                     bias[6 * b + 2 * i + 1])
        total = y if total is None else total + y
    return (total / 3).to(torch.bfloat16).transpose(1, 2)


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


def _operands(rng, B: int, C: int, T: int):
    x = rng.normal(0, 1, (B, C, T)).astype(np.float32)
    (w3, w7, w11), bias = pallas_mrf.pack_mrf_weights(_stage_tree(rng, C), KS, DS)
    mats = [torch.from_numpy(np.asarray(a)) for a in (w3, w7, w11)]
    return x, (w3, w7, w11), bias, mats, torch.from_numpy(np.asarray(bias))


def _cases():
    """(C, T, B): inside one tile, one tile less one frame, one tile, one
    tile and one frame, a few tiles; at C 256, whose tile is 64 frames, the
    first two are one case."""
    out = []
    for C in UNIT_KERNEL_WIDTHS:
        tile = unit_tile_frames(C)
        out += [(C, T, B) for T, B in ((20, 2), (tile - 1, 1), (tile, 1), (tile + 1, 2),
                                       (2 * tile + 37, 1)) if C < 256 or T != 20]
    return out


def _ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each |v| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.parametrize("C,T,B", _cases(), ids=[f"C{c}-T{t}-B{b}" for c, t, b in _cases()])
def test_the_unit_walk_rounds_where_the_tpu_kernel_does(C, T, B):
    rng = np.random.default_rng(1000 * C + T)
    x, (w3, w7, w11), bias, mats, biases = _operands(rng, B, C, T)
    tpu = pallas_mrf.mrf_stage_fused(jnp.asarray(x), w3, w7, w11, bias, t_tile=256,
                                     dtype=jnp.bfloat16, interpret=True)
    xt = torch.from_numpy(x)
    got = emulated_unit(xt, mats, biases).float()
    assert got.shape == (B, C, T) and bool(torch.isfinite(got).all())
    ref = torch.from_numpy(np.asarray(tpu).astype(np.float32))
    plain = mrf_stage_fused_reference(xt, *mats, biases, dtype=torch.bfloat16).float()
    floor = torch.maximum(ref.abs(), ref.abs().max() / 8)
    for name, out in (("emulation", got), ("plain", plain)):
        assert ((out - ref).abs() / _ulp(floor)).max().item() <= ULPS, name
    spread = (plain != ref).float().mean().item()
    differ = (got != ref).float().mean().item()
    assert differ <= spread + DIFFER_SHARE, (differ, spread)


@pytest.mark.parametrize("C", UNIT_KERNEL_WIDTHS)
def test_unit_tiles_meet_without_a_seam_and_sum_as_the_chain(C):
    """The design's tiles, 64-frame tiles and one tile spanning all of T give
    the same bits, and so does the conv chain's whole-sequence walk in the
    same grouping: the two designs compute the same numbers."""
    rng = np.random.default_rng(C)
    T = 2 * unit_tile_frames(C) + 37
    x, _, _, mats, biases = _operands(rng, 2, C, T)
    x = torch.from_numpy(x)
    whole = emulated_unit(x, mats, biases, m_out=64 * -(-T // 64))
    assert torch.equal(emulated_unit(x, mats, biases), whole)
    assert torch.equal(emulated_unit(x, mats, biases, m_out=64), whole)
    assert torch.equal(emulated_chain(x, mats, biases), whole)


# (C, B, T, route): B 1 and 2 at short lengths, B 16 at the served lengths of
# HiFi-GAN V1's four stages (mel length 1000); fp32 takes the chain throughout
ROUTES = (
    (32, 1, 2000, "chain"),        # 6 one-pass tiles for 132 SMs
    (32, 1, 50688, "onepass"),     # 132: one a SM
    (16, 2, 20000, "chain"),       # 46
    (16, 2, 59136, "onepass"),     # 132
    (8, 2, 256, "chain"),
    (64, 1, 5000, "chain"),        # 81 unit items: 0.6 a SM
    (64, 2, 33792, "unit"),        # 1056: 8 a SM
    (64, 2, 33600, "chain"),       # 1050: one tile short
    (256, 16, 8000, "chain"),
    (128, 16, 64000, "chain"),
    (64, 16, 128000, "unit"),
    (32, 16, 256000, "onepass"),
)


@pytest.mark.parametrize("C,B,T,want", ROUTES,
                         ids=[f"C{c}-B{b}-T{t}" for c, b, t, _ in ROUTES])
def test_the_route_counts_frame_tiles(C, B, T, want):
    assert mrf_route(C, torch.bfloat16, KS, DS, B, T) == want
    assert mrf_route(C, torch.float32, KS, DS, B, T) == "chain"
    # the same stage on a card of half the SMs has twice the items per SM
    big = mrf_route(C, torch.bfloat16, KS, DS, B, T, sms=SMS // 2)
    assert big == want or (want == "chain" and big != "chain")


def test_the_size_rule_holds_each_design_to_its_items_per_sm():
    """A design takes a stage from MIN_ITEMS_PER_SM of its work items per SM
    on: one frame tile short of it, the chain."""
    for design, C in (("onepass", 32), ("unit", 64)):
        tile = 384 if design == "onepass" else unit_tile_frames(C)
        per = design_items(design, C, 1, tile)
        tiles = int(np.ceil(MIN_ITEMS_PER_SM[design] * SMS / per))
        assert design_items(design, C, 1, tiles * tile) >= MIN_ITEMS_PER_SM[design] * SMS
        assert mrf_route(C, torch.bfloat16, KS, DS, 1, tiles * tile) == design
        assert mrf_route(C, torch.bfloat16, KS, DS, 1, (tiles - 1) * tile) == "chain"
    # without a shape the width decides alone
    assert mrf_route(64, torch.bfloat16) == "unit" and mrf_route(128, torch.bfloat16) == "chain"
    assert design_items("unit", 64, 2, 193) == 3 * 2 * 2
    assert design_items("onepass", 32, 2, 385) == 2 * 2


def test_the_unit_design_is_built_for_c_64_to_256_and_routed_where_it_won():
    for C in (8, 16, 32, 64, 128, 256, 512):
        assert unit_takes(C, torch.bfloat16) == (C in UNIT_KERNEL_WIDTHS)
        assert not unit_takes(C, torch.float32)
    assert set(UNIT_WIDTHS) <= set(UNIT_KERNEL_WIDTHS)
    # a conv reaching past the 32 margin rows keeps the chain
    assert not unit_takes(64, torch.bfloat16, (3, 7, 11), ((1, 3, 5), (1, 3, 5), (1, 3, 7)))
    assert unit_takes(64, torch.bfloat16, (3, 7, 9), ((1, 3, 5),) * 3)
    assert mrf_route(64, torch.bfloat16, (3, 7, 11), ((1, 3, 5), (1, 3, 5), (1, 3, 7))) == "chain"
    for C in UNIT_KERNEL_WIDTHS:
        assert unit_tile_frames(C) % 64 == 0


def test_the_tile_table_matches_the_kernel_source():
    """`unit_tile_frames` and the reach `unit_takes` allows mirror
    `csrc/mrf.cu` (Unit<C>::M, UNIT_MARGIN): the route counts the kernel's
    own tiles, and the emulation walks them."""
    src = (pathlib.Path(__file__).resolve().parents[1] / "visual_onoma_to_wave_tpu_torch" /
           "csrc" / "mrf.cu").read_text()
    m = re.search(r"static constexpr int M = C == 256 \? (\d+) : (\d+);", src)
    assert m, "Unit<C>::M moved in csrc/mrf.cu"
    assert {C: unit_tile_frames(C) for C in UNIT_KERNEL_WIDTHS} == \
        {64: int(m.group(2)), 128: int(m.group(2)), 256: int(m.group(1))}
    margin = int(re.search(r"constexpr int UNIT_MARGIN = (\d+);", src).group(1))
    assert margin == MARGIN
    assert unit_takes(64, torch.bfloat16, (3, 3, 3), ((margin,) * 3,) * 3)
    assert not unit_takes(64, torch.bfloat16, (3, 3, 3), ((margin + 1,) * 3,) * 3)


def test_the_unit_launch_refuses_other_operands_and_the_cpu():
    """What the route does not send to the unit design raises there, and so
    does a tensor off the card (checked last)."""
    g = torch.Generator().manual_seed(0)
    mats = [torch.randn(6, 64, k * 64, generator=g) for k in KS]
    packed = pack_mrf_kernel_weights(mats, torch.bfloat16)
    bias = torch.zeros(18, 64, 1)
    x = torch.randn(1, 64, 50, generator=g).to(torch.bfloat16)
    before = mrf_stage_unit.launches
    with pytest.raises(ValueError, match="contiguous bf16"):
        mrf_stage_unit(x.float(), packed, bias)
    with pytest.raises(ValueError, match="C in"):
        mrf_stage_unit(torch.zeros(1, 32, 50, dtype=torch.bfloat16), packed, bias)
    with pytest.raises(ValueError, match="reach"):
        mrf_stage_unit(x, packed, bias, dilations=((9, 9, 9),) * 3)
    with pytest.raises(ValueError, match="packed weights"):
        mrf_stage_unit(x, packed[::-1], bias)
    with pytest.raises(ValueError, match="unsupported device"):
        mrf_stage_unit(x, packed, bias)
    assert mrf_stage_unit.launches == before
