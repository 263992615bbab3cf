"""Where the attention kernel (`csrc/flash_mha.cu`) rounds in bf16, on the CPU.

The TPU kernel `flash_mha` normalises the probabilities first and then rounds
them to bf16 for the product with V (`pallas_attention.py:83`). The port's
bf16 kernel does the same in two passes over the live 64-key tiles:

    pass 1  m, l = the row's max and sum(exp(s - m)), online over the tiles
    pass 2  P = bf16_rn(exp(s - m) * (1/l)); O += P V (a fresh fp32 sum a tile)
            ctx = bf16_rn(O)

`two_pass_emulation` repeats that arithmetic in plain PyTorch (S as one fresh
fp32 sum per 64 of dk, dead tiles skipped). `one_pass_emulation` repeats the
one-pass rounding the port's bf16 kernel had before: exp(s - running max)
rounded to bf16 per tile, the running sum over the unrounded values, the
context divided by it at the end (`tools/bf16_attention_gap_torch.py`).

Held here, against the TPU kernel run in interpret mode on the same bf16
inputs (at dk 64, which `flash_mha` refuses, its kernel body `_mha_kernel`
through `pl.pallas_call` directly):
  * the two-pass emulation differs in at most DIFFER_SHARE of the output
    elements, each by at most one bf16 ulp at each of the two roundings: one
    ulp of the TPU kernel's value, plus one ulp of each probability times
    its |v| (`_rounding_bound`). What differs is roundoff: l summed online
    and tile by tile, the products summed in another order, XLA's exp
    against torch's. Each moves an fp32 value by a few ulp, which now and
    then flips the bf16 rounding of one probability; that moves every
    output of its row by a fraction of an ulp, and flips some of them. Where
    an output cancels to near 0, that step is many of its own ulp, hence
    the second term. The share this leaves is a floor that any two faithful
    implementations share: `attention_core_reference`, which rounds where
    the TPU kernel does, differs from it in up to 1.49e-3 of the elements on
    these inputs (T 1000, dk 128, no mask), the two-pass emulation in up to
    1.34e-3. DIFFER_SHARE is 5e-3, about three times that floor;
  * fully padded items give exact zeros;
  * the one-pass emulation differs in at least ONE_PASS_RATIO times as many
    elements (it differs in 11-50% of them): its rounding point is a fault
    of its own, not roundoff.

A case marked `gpu` holds the kernel itself to `attention_core_reference`
(which rounds as the TPU kernel does) by the same share; it needs the card.
This file imports JAX only inside the CPU cases, so that the `gpu` case runs
where JAX is not installed.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from visual_onoma_to_wave_tpu_torch.ops.attention import (
    attention_core,
    attention_core_reference,
)

TILE = 64             # keys per tile, and dk columns per tensor-core sum
DIFFER_SHARE = chip_smoke.BF16_DIFFER_SHARE   # of the output elements (5e-3; above)
ONE_PASS_RATIO = 10   # the one-pass rounding differs in at least this many times as many
H = 2
MASKS = ("none", "tail", "full", "holes")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def two_pass_emulation(q, k, v, key_pad_mask, n_head: int) -> torch.Tensor:
    """The bf16 kernel's arithmetic on (B, T, H*dk) bf16 heads; key_pad_mask
    (B, T), True = padding, or None. Returns bf16."""
    B, T, HD = q.shape
    dk = HD // n_head
    qh, kh, vh = (x.float().reshape(B, T, n_head, dk).transpose(1, 2) for x in (q, k, v))
    valid = (torch.ones(B, T, dtype=torch.bool) if key_pad_mask is None
             else ~key_pad_mask.bool())
    s = sum(qh[..., d0:d0 + TILE] @ kh[..., d0:d0 + TILE].transpose(-1, -2)
            for d0 in range(0, dk, TILE))
    s = torch.where(valid[:, None, None, :], s * (1.0 / dk ** 0.5), -torch.inf)
    # per item, whether a tile holds a valid key: the kernel skips the others
    tiles = [(k0, valid[:, k0:k0 + TILE].any(-1)[:, None, None, None])
             for k0 in range(0, T, TILE)]
    m = torch.full((B, n_head, T, 1), -torch.inf)
    l = torch.zeros(B, n_head, T, 1)
    for k0, live in tiles:                      # pass 1
        st = s[..., k0:k0 + TILE]
        m_new = torch.where(live, torch.maximum(m, st.amax(-1, keepdim=True)), m)
        l = torch.where(live, l * torch.exp(m - m_new)
                        + torch.exp(st - m_new).sum(-1, keepdim=True), l)
        m = m_new
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    o = torch.zeros(B, n_head, T, dk)
    for k0, live in tiles:                      # pass 2
        p = _bf16(torch.exp(s[..., k0:k0 + TILE] - m) * inv)
        o = o + torch.where(live, p @ vh[..., k0:k0 + TILE, :], 0.0)
    return o.transpose(1, 2).reshape(B, T, HD).to(torch.bfloat16)


def one_pass_emulation(q, k, v, key_pad_mask, n_head: int) -> torch.Tensor:
    """The earlier one-pass bf16 rounding (a copy of
    `tools/bf16_attention_gap_torch.py::unnormalised_reference`)."""
    B, T, HD = q.shape
    dk = HD // n_head
    qh, kh, vh = (x.reshape(B, T, n_head, dk).transpose(1, 2).float() for x in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / dk ** 0.5)
    if key_pad_mask is not None:
        s = s.masked_fill(key_pad_mask[:, None, None, :], -torch.inf)
    m = torch.full(s.shape[:-1] + (1,), -torch.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(B, n_head, T, dk)
    for j in range(0, T, TILE):
        st = s[..., j:j + TILE]
        live = (st > -torch.inf).any(-1, keepdim=True)
        m_new = torch.where(live, torch.maximum(m, st.amax(-1, keepdim=True)), m)
        alpha = torch.where(live, torch.exp(m - m_new), torch.ones_like(m))
        p = torch.where(live, torch.exp(st - m_new), torch.zeros_like(st))
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(q.dtype).float() @ vh[..., j:j + TILE, :]
        m = m_new
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    return (o * inv).transpose(1, 2).reshape(B, T, HD).to(q.dtype)


def tpu_kernel(q, k, v, key_pad_mask, n_head: int) -> torch.Tensor:
    """The JAX package's kernel in interpret mode on the same bf16 values."""
    import functools

    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from visual_onoma_to_wave_tpu.ops.pallas_attention import _mha_kernel, flash_mha

    B, T, HD = q.shape
    dk = HD // n_head
    q_, k_, v_ = (jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16) for x in (q, k, v))
    mask = jnp.asarray((torch.zeros(B, T, dtype=torch.bool) if key_pad_mask is None
                        else key_pad_mask).numpy())
    if dk % 128 == 0:
        out = flash_mha(q_, k_, v_, mask, n_head, interpret=True)
    else:   # the wrapper takes dk % 128 == 0 only; its kernel body takes any dk
        item = pl.BlockSpec((1, T, HD), lambda b: (b, 0, 0))
        out = pl.pallas_call(
            functools.partial(_mha_kernel, n_head=n_head, scale=1.0 / float(dk) ** 0.5),
            out_shape=jax.ShapeDtypeStruct((B, T, HD), jnp.bfloat16),
            grid=(B,),
            in_specs=[item, item, item, pl.BlockSpec((1, 1, T), lambda b: (b, 0, 0))],
            out_specs=item, interpret=True,
        )(q_, k_, v_, mask.astype(jnp.float32).reshape(B, 1, T))
    return torch.from_numpy(np.array(out.astype(jnp.float32))).to(torch.bfloat16)


def _inputs(B, T, dk, mask_kind, seed, device="cpu"):
    """bf16 q, k, v (B, T, H*dk) from a numpy seed, a key mask of the kind
    chip_smoke's parity grid uses, and the fully padded items."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, T, H * dk)).astype(np.float32))
               .to(torch.bfloat16).to(device) for _ in range(3))
    if mask_kind == "none":
        return q, k, v, None, []
    lens = rng.integers(1, T + 1, size=B)
    lens[0] = T
    full = [1, B - 1] if mask_kind == "full" else []
    lens[full] = 0
    t = np.arange(T)[None, :]
    mask = t >= lens[:, None]
    if mask_kind == "holes":   # even items lose tiles 1, 3, ..., odd items 0, 2, ...
        mask = mask | ((t // TILE + np.arange(B)[:, None]) % 2 == 1)
    return q, k, v, torch.from_numpy(mask).to(device), full


def _ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each |x| (bf16 keeps 8 significant bits: the ulp of x
    in [2**(e-1), 2**e) is 2**(e-8)); 0 for 0."""
    exponent = torch.frexp(x.float().abs()).exponent
    return torch.where(x == 0, 0.0, torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                                                exponent - 8))


def _differ(got, ref, q, k, v, key_pad_mask) -> tuple[torch.Tensor, torch.Tensor]:
    """The elements of `got` that differ from `ref`, and whether each lies
    within one bf16 ulp at each rounding of `ref`: of the value, and of each
    normalised probability (fp32) times its |v|, summed over the keys."""
    q, k, v, got, ref = (x.cpu().float() for x in (q, k, v, got, ref))
    B, T, HD = q.shape
    dk = HD // H
    qh, kh, vh = (x.reshape(B, T, H, dk).transpose(1, 2) for x in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / dk ** 0.5)
    if key_pad_mask is not None:
        s = s.masked_fill(key_pad_mask.cpu()[:, None, None, :], -torch.inf)
    p = torch.nan_to_num(torch.softmax(s, dim=-1))
    step = (_ulp(p) @ vh.abs()).transpose(1, 2).reshape(B, T, HD)
    return got != ref, (got - ref).abs() <= _ulp(ref) + step


# the encoder's T 8, a T inside two tiles, the decoder's max_mel_len 1000
CASES = [(T, dk, kind) for T in (8, 100, 1000) for dk in (64, 128) for kind in MASKS]


@pytest.mark.parametrize("T,dk,mask_kind", CASES)
def test_two_passes_round_where_the_tpu_kernel_does(T, dk, mask_kind):
    q, k, v, mask, full = _inputs(4 if T < 1000 else 2, T, dk, mask_kind, seed=T + dk)
    tpu = tpu_kernel(q, k, v, mask, H)
    two = two_pass_emulation(q, k, v, mask, H)
    one = one_pass_emulation(q, k, v, mask, H)
    differ, within = _differ(two, tpu, q, k, v, mask)
    n_two, n_one = int(differ.sum()), int((one.float() != tpu.float()).sum())
    print(f"T={T} dk={dk} {mask_kind}: {q.numel()} elements, two-pass differs in {n_two}, "
          f"one-pass in {n_one}")
    assert n_two <= DIFFER_SHARE * q.numel()
    assert bool(within[differ].all())
    for b in full:
        assert bool((two[b] == 0).all()) and bool((tpu[b] == 0).all())
    assert n_one > 0 and n_one >= ONE_PASS_RATIO * n_two


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from visual_onoma_to_wave_tpu_torch.precision import pin_fp32

    pin_fp32()
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("T,dk,mask_kind", CASES)
def test_kernel_rounds_where_the_plain_version_does(cuda, T, dk, mask_kind):
    q, k, v, mask, full = _inputs(8, T, dk, mask_kind, seed=T + dk, device=cuda)
    before = attention_core.launches
    out = attention_core(q, k, v, mask, H)
    ref = attention_core_reference(q, k, v, mask, H)
    torch.cuda.synchronize()
    assert attention_core.launches == before + 1
    differ, within = _differ(out, ref, q, k, v, mask)
    assert int(differ.sum()) <= DIFFER_SHARE * q.numel()
    assert bool(within[differ].all())
    for b in full:
        assert bool((out[b] == 0).all())
