"""The port's attention core (`ops/attention.py`) against the JAX reference.

`attention_core_reference` (the plain PyTorch version, which CPU tensors
take) against the TPU kernel `flash_mha` run in interpret mode (dk 128)
and against the XLA path of the JAX `MultiHeadAttention` (dk 64 and 128),
with key padding none / tail / full; a fully padded item gives exactly 0.
The wrapper and the CUDA kernel itself are tested in test_torch_kernels.py,
which imports no JAX so that it also runs on the card.

Tolerances: float32 on both sides, differing only in summation order:
2e-6 absolute on the core (as tests/test_pallas_attention.py), 1e-5 after
the output projection and LayerNorm. bfloat16: 2e-2 (the probabilities
are rounded to bf16 before the product with V).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu.models.layers import MultiHeadAttention as JMultiHeadAttention
from visual_onoma_to_wave_tpu.ops.pallas_attention import flash_mha
from visual_onoma_to_wave_tpu_torch.models.layers import MultiHeadAttention
from visual_onoma_to_wave_tpu_torch.ops.attention import attention_core_reference

from test_torch_layers import init_random, port

PADDINGS = {"none": lambda T: [T, T, T], "tail": lambda T: [T, 70 * T // 128, 1],
            "full": lambda T: [T, 33 * T // 100, 0]}


def qkv(B, T, HD, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, HD)).astype(np.float32) for _ in range(3)]


def mask_for(kind: str, T: int) -> np.ndarray:
    return np.arange(T)[None, :] >= np.asarray(PADDINGS[kind](T))[:, None]


@pytest.mark.parametrize("kind", list(PADDINGS))
@pytest.mark.parametrize("T", [128, 100])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-6), ("bfloat16", 2e-2)])
def test_reference_matches_flash_mha_interpret(kind, T, dtype, tol):
    H, dk = 2, 128
    q, k, v = qkv(3, T, H * dk, seed=T)
    mask = mask_for(kind, T)
    jx = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    ref = np.asarray(flash_mha(*jx, jnp.asarray(mask), H, interpret=True), np.float32)
    tdt = getattr(torch, dtype)
    out = attention_core_reference(*(torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                                     for a in jx), torch.from_numpy(mask), H)
    assert out.dtype == tdt and out.shape == (3, T, H * dk)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=tol)
    if kind == "full":
        assert (out[2] == 0).all()   # fully padded item: exactly 0


@pytest.mark.parametrize("kind", list(PADDINGS))
@pytest.mark.parametrize("d_model,T", [(128, 24), (256, 100)], ids=["dk64", "dk128"])
def test_multi_head_attention_matches_jax(kind, d_model, T):
    """The port's module (projections, core, residual post-LN) against the
    JAX module's XLA path with the same parameters."""
    H = 2
    rng = np.random.default_rng(d_model)
    x = rng.normal(size=(3, T, d_model)).astype(np.float32)
    mask = mask_for(kind, T)
    jm = JMultiHeadAttention(H, d_model, d_model // H, d_model // H)
    v = init_random(jm, rng, x, None, True, key_pad_mask=mask, scale=0.1)
    ref = jm.apply(v, x, None, True, key_pad_mask=mask)
    tm = port(MultiHeadAttention(H, d_model, d_model // H, d_model // H), v)
    with torch.inference_mode():
        out = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
