"""The ConvNeXt kernels' packed weights (`ops/convnext.py::pack_convnext_weights`)
and why fp32 runs as 3xTF32, on the CPU.

No JAX here. The packing is checked by undoing it (exact for fp32: hi + lo
is the weight) and by reading single planes the way the kernel's wgmma
descriptors do. The Vocos modules keep their packed weights until a weight
changes. Last, a CPU emulation of the kernels' tensor-core products over 8
chained blocks: 3xTF32 (hi*lo + lo*hi + hi*hi, each operand split into a
TF32 part and the TF32-truncated remainder, fp32 sums) stays within
chip_smoke's 5e-5 fp32 bound of the plain fp32 trunk, and one TF32 product
alone (hi*hi) does not.
"""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from visual_onoma_to_wave_tpu_torch.models.vocos import ConvNeXtBlock, VocosGenerator
from visual_onoma_to_wave_tpu_torch.ops.convnext import (
    convnext_trunk_reference,
    pack_convnext_weights,
    tf32_round,
)

PLANE_BYTES, MC = 16384, 64      # csrc/convnext.cu's plane and chunk
WIDTHS = [pytest.param(C, M, id=f"C{C}-M{M}") for C, M in chip_smoke.CONVNEXT_WIDTHS]
DTYPES = [pytest.param(torch.float32, id="fp32"), pytest.param(torch.bfloat16, id="bf16")]


def _weights(L, C, M, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(L, C, M, generator=g) * C ** -0.5, torch.randn(L, M, C, generator=g)


def _untile(p: torch.Tensor, N: int, K: int, ck: int) -> torch.Tensor:
    """(..., N * K) in 8-row x ck-column core matrices -> (..., N, K)."""
    p = p.reshape(*p.shape[:-1], K // ck, N // 8, 8, ck).movedim(-4, -2)
    return p.reshape(*p.shape[:-4], N, K)


def _unpack(packed: torch.Tensor, L: int, C: int, M: int):
    """The inverse of `pack_convnext_weights`: (w1 (L, C, M), w2 (L, M, C)),
    fp32 as hi + lo."""
    size = packed.element_size()
    plane, ck = PLANE_BYTES // size, 16 // size
    ks1, ks2 = plane // MC, plane // C
    s1, s2, split = C // ks1, MC // ks2, 2 if packed.dtype == torch.float32 else 1
    stream = packed.reshape(L, M // MC, s1 + s2, split, plane)
    planes = stream.sum(3) if split == 2 else stream[:, :, :, 0]
    halves = planes[:, :, :s1].reshape(L, M // MC, s1, 2, plane // 2)
    b1 = _untile(halves, MC, ks1 // 2, ck)                  # (L, J, S1, 2, MC, KS1 / 2)
    b2 = _untile(planes[:, :, s1:], C, ks2, ck)             # (L, J, S2, C, KS2)
    w1t = b1.permute(0, 1, 4, 3, 2, 5).reshape(L, M, C)
    w2t = b2.permute(0, 3, 1, 2, 4).reshape(L, C, M)
    return w1t.transpose(1, 2), w2t.transpose(1, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C,M", WIDTHS)
def test_packing_round_trips(C, M, dtype):
    w1, w2 = _weights(2, C, M)
    packed = pack_convnext_weights(w1, w2, dtype)
    assert packed.dtype == dtype and packed.is_contiguous()
    assert packed.shape == (2, C * M * (4 if dtype == torch.float32 else 2))
    u1, u2 = _unpack(packed, 2, C, M)
    assert torch.equal(u1, w1.to(dtype)) and torch.equal(u2, w2.to(dtype))
    # one block packs as the first layer of the stack
    assert torch.equal(pack_convnext_weights(w1[0], w2[0], dtype), packed[0])


def test_fp32_planes_are_hi_then_lo_and_sum_to_the_weight():
    C, M = 128, 384
    w1, w2 = _weights(1, C, M, seed=1)
    stream = pack_convnext_weights(w1[0], w2[0]).reshape(-1, 2, PLANE_BYTES // 4)
    hi, lo = stream[:, 0], stream[:, 1]
    assert torch.equal(hi, tf32_round(hi))
    assert (lo.abs() <= hi.abs() * 2.0 ** -11).all()   # lo is the remainder below hi's bits
    # the first plane is W1^T rows 0..63 (the first chunk of M) in two
    # blocks, columns 0..31 of C, then columns C/2..C/2+31: the first core
    # matrix holds W1^T[0:8, 0:4], row by row
    first = hi[0] + lo[0]
    assert torch.equal(first[:32].reshape(8, 4), w1[0, 0:4, 0:8].t())
    # the next core matrix along N (rows 8..15) follows at 128 bytes
    assert torch.equal(first[32:64].reshape(8, 4), w1[0, 0:4, 8:16].t())
    # the next along K (columns 4..7) follows all 8 row blocks of the block
    assert torch.equal(first[256:288].reshape(8, 4), w1[0, 4:8, 0:8].t())
    # the second block (the other warpgroup's half of C) starts half way
    half = PLANE_BYTES // 8
    assert torch.equal(first[half:half + 32].reshape(8, 4), w1[0, C // 2:C // 2 + 4, 0:8].t())


def test_hi_keeps_at_most_10_mantissa_bits_rounding_ties_away():
    w = torch.randn(4096, generator=torch.Generator().manual_seed(2))
    hi = tf32_round(w)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert ((hi - w).abs() <= w.abs() * 2.0 ** -11).all()
    one = torch.tensor(1.0)
    ulp = 2.0 ** -10
    ties = torch.stack([one + ulp / 2, -(one + ulp / 2), one + ulp * 1.5,
                        one + ulp / 2 - 2 ** -23])
    want = torch.stack([one + ulp, -(one + ulp), one + 2 * ulp, one])
    assert torch.equal(tf32_round(ties), want)


def test_packing_refuses_what_the_kernels_do_not_take():
    w1, w2 = _weights(1, 128, 384)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        pack_convnext_weights(w1, w2, torch.float16)
    with pytest.raises(ValueError, match="C in"):
        pack_convnext_weights(w1[:, :64], w2[:, :, :64])
    with pytest.raises(ValueError, match="multiple of 128"):
        pack_convnext_weights(w1[:, :, :192], w2[:, :192])


def _bump(param: torch.nn.Parameter) -> None:
    with torch.no_grad():
        param.add_(0.0)     # an in-place write: same values, a new version


def test_block_repacks_only_when_a_packed_weight_changes():
    blk = ConvNeXtBlock(128, 384, layer_scale_init=0.25)
    first = blk.packed(torch.float32)
    assert blk.packed(torch.float32) is first
    _bump(blk.gamma)                              # not a packed weight
    assert blk.packed(torch.float32) is first
    bf16 = blk.packed(torch.bfloat16)             # another operand type packs anew
    assert bf16.dtype == torch.bfloat16 and blk.packed(torch.bfloat16) is bf16
    _bump(blk.pw2_w)
    second = blk.packed(torch.bfloat16)
    assert second is not bf16 and torch.equal(second, bf16)
    state = {k: v.clone() for k, v in blk.state_dict().items()}
    state["pw1_w"] = state["pw1_w"] * 2
    blk.load_state_dict(state)
    third = blk.packed(torch.float32)
    assert third is not first
    assert torch.equal(third, pack_convnext_weights(blk.pw1_w, blk.pw2_w))


def test_generator_restacks_the_trunk_only_when_a_weight_changes():
    gen = VocosGenerator(dim=128, intermediate_dim=384, num_layers=3)
    stacked, packed = gen.stacked_blocks(torch.float32)
    assert packed is None                         # CPU: the plain trunk needs no packing
    assert len(stacked) == 9 and stacked[4].shape == (3, 128, 384)
    assert gen.stacked_blocks(torch.float32)[0] is stacked
    _bump(gen.embed_w)                            # not a block weight
    assert gen.stacked_blocks(torch.float32)[0] is stacked
    _bump(gen.blocks[2].norm_bias)
    again = gen.stacked_blocks(torch.float32)[0]
    assert again is not stacked
    assert all(torch.equal(a, b) for a, b in zip(again, stacked))
    state = gen.state_dict()
    state["blocks.1.gamma"] = state["blocks.1.gamma"] + 1
    gen.load_state_dict(state)
    assert torch.equal(gen.stacked_blocks(torch.float32)[0][8][1], gen.blocks[1].gamma)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an fp32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tc_matmul(a: torch.Tensor, b: torch.Tensor, three: bool) -> torch.Tensor:
    """a @ b as the kernel's tensor cores take it: TF32 operands, fp32 sums;
    3xTF32 adds the two cross terms of the remainders."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    out = a_hi @ b_hi
    if three:
        out = _tf32_trunc(a - a_hi) @ b_hi + a_hi @ _tf32_trunc(b - b_hi) + out
    return out


def _emulated_trunk(x, dw, db, ls, lb, w1, b1, w2, b2, gamma, three: bool, eps=1e-6):
    """`convnext_trunk_reference` (fp32, tanh GELU) with both products as
    `_tc_matmul`."""
    for dw_, db_, ls_, lb_, w1_, b1_, w2_, b2_, g_ in zip(dw, db, ls, lb, w1, b1, w2, b2, gamma):
        K, C = dw_.shape[0], x.shape[-1]
        h = F.conv1d(F.pad(x.transpose(1, 2), ((K - 1) // 2,) * 2),
                     dw_.reshape(K, C).t()[:, None, :], groups=C).transpose(1, 2) + db_
        h = F.layer_norm(h, (C,), ls_, lb_, eps)
        a = F.gelu(_tc_matmul(h, w1_, three) + b1_, approximate="tanh")
        x = x + g_ * (_tc_matmul(a, w2_, three) + b2_)
    return x


@pytest.mark.parametrize("three", [True, False], ids=["3xTF32", "1xTF32"])
@pytest.mark.parametrize("C,M", WIDTHS)
def test_only_3xtf32_holds_the_fp32_bound_over_8_blocks(C, M, three):
    g = torch.Generator().manual_seed(3)
    ws = chip_smoke.convnext_weights(8, C, M, g, "cpu")
    x = torch.randn(1, 256, C, generator=g)
    with torch.no_grad():
        ref = convnext_trunk_reference(x, *ws)
        err = (_emulated_trunk(x, *ws, three=three) - ref).abs().max().item()
    atol = chip_smoke.CONVNEXT_ATOL[torch.float32]
    print(f"C={C} M={M} {'3x' if three else '1x'}TF32: max abs err {err:.3e} (bound {atol})")
    assert (err < atol) if three else (err > atol), err
