"""Why the attention kernel (`csrc/flash_mha.cu`) runs fp32 as 3xTF32, and why
skipping dead key tiles is exact, on the CPU.

`emulated_attention` repeats the kernel's arithmetic in plain PyTorch: keys
in 64-key tiles, an online softmax over them, S = Q K^T as one fresh
tensor-core sum per 64 columns of dk, each tile's P V a fresh sum added to
the running context as O = alpha O + fresh, and every product as the tensor
cores take fp32 operands: 3xTF32 (hi*lo + lo*hi + hi*hi, hi = `tf32_round`,
the remainders truncated to TF32 as the tensor cores read them) or one TF32
product. Tiles whose keys are all padding are skipped, as the kernel skips
them, or visited with the guards of a kernel that visits every tile.

Held here:
  * at the served decoder's shape (T 1000, dk 128, 480 valid keys) 3xTF32
    lands within the kernel's 1e-5 fp32 bound (chip_smoke.ATOL) of both the
    TPU kernel `flash_mha` in interpret mode and `attention_core_reference`;
    one TF32 product misses it (3.4e-4; 3xTF32 4.8e-7);
  * skipping dead tiles gives bit-equal results to visiting them, under a
    "holes" mask where whole interior key tiles are padding, and a fully
    padded item gives exact zeros.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from visual_onoma_to_wave_tpu.ops.pallas_attention import flash_mha
from visual_onoma_to_wave_tpu_torch.ops.attention import attention_core_reference
from visual_onoma_to_wave_tpu_torch.ops.convnext import tf32_round

TILE = 64     # keys per tile, and dk columns per tensor-core sum (csrc/flash_mha.cu)
ATOL = chip_smoke.ATOL[torch.float32]


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an fp32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _tc_matmul(a: torch.Tensor, b: torch.Tensor, three: bool) -> torch.Tensor:
    """a @ b as the kernel's tensor cores take it, one fresh sum over K: TF32
    operands, fp32 sums; 3xTF32 adds the two cross terms of the remainders."""
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    out = a_hi @ b_hi
    if three:
        out = a_hi @ _tf32_trunc(b - b_hi) + _tf32_trunc(a - a_hi) @ b_hi + out
    return out


def emulated_attention(q, k, v, key_pad_mask, n_head: int, three: bool = True,
                       skip: bool = True) -> torch.Tensor:
    """The kernel's fp32 arithmetic on (B, T, H*dk) heads; key_pad_mask (B, T),
    True = padding, or None."""
    B, T, HD = q.shape
    dk = HD // n_head
    scale = 1.0 / dk ** 0.5
    qh, kh, vh = (x.float().reshape(B, T, n_head, dk).transpose(1, 2) for x in (q, k, v))
    valid = (torch.ones(B, T, dtype=torch.bool) if key_pad_mask is None
             else ~key_pad_mask.bool())
    out = torch.zeros(B, n_head, T, dk)
    for b in range(B):
        m = torch.full((n_head, T, 1), -torch.inf)
        l = torch.zeros(n_head, T, 1)
        o = torch.zeros(n_head, T, dk)
        for k0 in range(0, T, TILE):
            ok = valid[b, k0:k0 + TILE]
            if skip and not bool(ok.any()):
                continue
            kt, vt = kh[b, :, k0:k0 + TILE], vh[b, :, k0:k0 + TILE]
            s = _tc_matmul(qh[b, :, :, :TILE], kt[..., :TILE].transpose(1, 2), three)
            for d0 in range(TILE, dk, TILE):
                s = s + _tc_matmul(qh[b, :, :, d0:d0 + TILE],
                                   kt[..., d0:d0 + TILE].transpose(1, 2), three)
            s = torch.where(ok, s * scale, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            # the guards a kernel that visits dead tiles needs: no exp(-inf + inf)
            alpha = torch.where(m == -torch.inf, 0.0, torch.exp(m - m_new))
            p = torch.where(s == -torch.inf, 0.0, torch.exp(s - m_new))
            l = l * alpha + p.sum(-1, keepdim=True)
            o = alpha * o + _tc_matmul(p, vt, three)
            m = m_new
        out[b] = o * torch.where(l > 0, 1.0 / l, 0.0)
    return out.transpose(1, 2).reshape(B, T, HD)


def _inputs(B, T, H, dk, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, T, H * dk)).astype(np.float32))
            for _ in range(3)]


def _holes(lens, T) -> torch.Tensor:
    """Tail padding past each length, and every other 64-key tile padding,
    starting with tile 1 for even items and tile 0 for odd ones."""
    t = torch.arange(T)[None, :]
    phase = torch.arange(len(lens))[:, None]
    return (t >= torch.tensor(lens)[:, None]) | ((t // TILE + phase) % 2 == 1)


@pytest.mark.parametrize("three", [True, False], ids=["3xTF32", "1xTF32"])
def test_only_3xtf32_holds_the_fp32_bound_at_the_served_shape(three):
    B, T, H, dk = 2, 1000, 2, 128
    q, k, v = _inputs(B, T, H, dk, seed=0)
    mask = torch.arange(T)[None, :] >= torch.tensor([480, T])[:, None]
    got = emulated_attention(q, k, v, mask, H, three=three)
    ref = attention_core_reference(q, k, v, mask, H)
    tpu = torch.from_numpy(np.array(flash_mha(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)), jnp.asarray(mask.numpy()), H,
        interpret=True)))
    errs = {"reference": (got - ref).abs().max().item(),
            "flash_mha": (got - tpu).abs().max().item()}
    print(f"{'3x' if three else '1x'}TF32 at T={T} dk={dk}: max abs err {errs} (bound {ATOL})")
    for err in errs.values():
        assert (err < ATOL) if three else (err > ATOL), errs


@pytest.mark.parametrize("dk", [64, 128])
@pytest.mark.parametrize("T", [200, 1000])
def test_skipping_dead_key_tiles_is_exact(T, dk):
    H = 2
    q, k, v = _inputs(4, T, H, dk, seed=T + dk)
    mask = _holes([T, T, 2 * T // 3, 100], T)
    mask[3] = True    # a fully padded item
    # items 0 and 1 lose whole tiles inside their length: tile 1, and tiles 0 and 2
    for b, dead in ((0, 1), (1, 0), (1, 2)):
        assert bool(mask[b, TILE * dead:TILE * (dead + 1)].all())
    skipped = emulated_attention(q, k, v, mask, H, skip=True)
    visited = emulated_attention(q, k, v, mask, H, skip=False)
    assert torch.equal(skipped, visited)
    assert (skipped[3] == 0).all()
    ref = attention_core_reference(q, k, v, mask, H)
    torch.testing.assert_close(skipped, ref, rtol=0.0, atol=ATOL)
