"""The fused MRF stage of the port (`ops/mrf.py`, kernel B2) against the JAX package, on the CPU.

Stage weights and inputs are made with numpy from a seed and given to both
packages. The JAX Pallas kernel runs in interpret mode, as the JAX package's
own tests run it (tests/test_pallas_mrf.py); on the CPU the port's wrapper
takes its plain version (the 18-conv chain in `F.conv1d`). Tolerances:

* fp32: 2e-6 x max |ref|, the JAX kernel's own bound against its XLA conv
  chain (tests/test_pallas_mrf.py:65): the same math summed in another order;
* bf16 (x, weights and every conv input rounded to bf16, fp32 sums, as the
  TPU kernel does): 2e-2 x max |ref|. An order difference in an fp32 sum can
  flip the bf16 rounding of a conv input, one bf16 step (2^-8 relative), and
  the flip travels through the later convs of the branch;
* packing: exact (the same numbers moved).
"""
from __future__ import annotations

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu.models import hifigan as jhifigan
from visual_onoma_to_wave_tpu.ops import pallas_mrf
from visual_onoma_to_wave_tpu_torch.bridge import hifigan_state_dict
from visual_onoma_to_wave_tpu_torch.models.hifigan import ResBlock1
from visual_onoma_to_wave_tpu_torch.ops import cuda_build
from visual_onoma_to_wave_tpu_torch.ops.mrf import (
    HALO,
    mrf_stage_fused,
    pack_mrf_weights,
    stage_halo,
)

KS = (3, 7, 11)
DS = ((1, 3, 5),) * 3


def _make_stage(rng, c):
    """A flax stage tree {resblock_j: {convs1_i_w (k, Cin, Cout), ...}}, as
    tests/test_pallas_mrf.py makes it."""
    stage = {}
    for j, k in enumerate(KS):
        p = {}
        for i in range(3):
            for nm in ("convs1", "convs2"):
                p[f"{nm}_{i}_w"] = rng.normal(0, 0.2, (k, c, c)).astype(np.float32)
                p[f"{nm}_{i}_b"] = rng.normal(0, 0.2, (c,)).astype(np.float32)
        stage[f"resblock_{j}"] = p
    return stage


def _xla_stage(stage, x):
    """The JAX generator's MRF stage (feature-last), tests/test_pallas_mrf.py::_xla_stage."""
    acc = None
    for j, k in enumerate(KS):
        p = stage[f"resblock_{j}"]
        y = x
        for i, d in enumerate(DS[j]):
            h = jax.nn.leaky_relu(y, 0.1)
            h = jhifigan._conv1d(h, p[f"convs1_{i}_w"], p[f"convs1_{i}_b"], dilation=d)
            h = jax.nn.leaky_relu(h, 0.1)
            h = jhifigan._conv1d(h, p[f"convs2_{i}_w"], p[f"convs2_{i}_b"], dilation=1)
            y = y + h
        acc = y if acc is None else acc + y
    return acc / len(KS)


def _port_blocks(stage, c):
    """The stage as the port's ResBlock1 modules, through the weight bridge
    (the generator names its blocks resblock_{i}_{j}; the JAX packer reads
    resblock_{j}, ROADMAP.md B2)."""
    tree = {"params": {"conv_pre_w": np.zeros((7, 80, c), np.float32),
                       "conv_pre_b": np.zeros(c, np.float32),
                       "conv_post_w": np.zeros((7, c, 1), np.float32),
                       "conv_post_b": np.zeros(1, np.float32),
                       **{f"resblock_0_{j}": stage[f"resblock_{j}"] for j in range(3)}}}
    sd = hifigan_state_dict(tree)
    blocks = [ResBlock1(c, k) for k in KS]
    for j, block in enumerate(blocks):
        block.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()
                               if k.startswith(f"resblocks.{j}.")})
    return blocks


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


@pytest.mark.parametrize("c,t", [(32, 700), (64, 256), (32, 512)])
def test_plain_version_matches_the_jax_kernel_and_chain_fp32(c, t):
    rng = np.random.default_rng(0)
    stage = _make_stage(rng, c)
    x = rng.normal(0, 1, (2, t, c)).astype(np.float32)
    chain = np.asarray(_xla_stage(stage, jnp.asarray(x)))
    (w3, w7, w11), bias = pallas_mrf.pack_mrf_weights(stage, KS, DS)
    kernel = np.asarray(pallas_mrf.mrf_stage_fused(
        jnp.asarray(x.transpose(0, 2, 1)), w3, w7, w11, bias, t_tile=256, dtype=jnp.float32,
        interpret=True)).transpose(0, 2, 1)
    before = mrf_stage_fused.launches
    # the JAX package's packing fed to the port's function
    out = mrf_stage_fused(torch.from_numpy(x.transpose(0, 2, 1).copy()),
                          *map(_t, (w3, w7, w11)), _t(bias)).numpy().transpose(0, 2, 1)
    assert mrf_stage_fused.launches == before          # the CPU runs the plain version
    assert out.shape == chain.shape == kernel.shape
    for ref in (chain, kernel):
        assert np.abs(out - ref).max() <= 2e-6 * np.abs(ref).max()


def test_plain_version_bf16_within_bound_of_the_jax_kernel():
    rng = np.random.default_rng(1)
    stage = _make_stage(rng, 32)
    x = rng.normal(0, 1, (2, 300, 32)).astype(np.float32)
    (w3, w7, w11), bias = pallas_mrf.pack_mrf_weights(stage, KS, DS)
    ref = np.asarray(pallas_mrf.mrf_stage_fused(
        jnp.asarray(x.transpose(0, 2, 1)), w3, w7, w11, bias, t_tile=256, dtype=jnp.bfloat16,
        interpret=True), np.float32)
    out = mrf_stage_fused(torch.from_numpy(x.transpose(0, 2, 1).copy()),
                          *map(_t, (w3, w7, w11)), _t(bias), dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert np.abs(out.float().numpy() - ref).max() <= 2e-2 * np.abs(ref).max()


def test_pack_mrf_weights_equals_the_jax_packing_both_ways():
    rng = np.random.default_rng(2)
    c = 32
    stage = _make_stage(rng, c)
    (j3, j7, j11), jbias = pallas_mrf.pack_mrf_weights(stage, KS, DS)
    (p3, p7, p11), pbias = pack_mrf_weights(_port_blocks(stage, c))
    for got, want in zip((p3, p7, p11, pbias), (j3, j7, j11, jbias)):
        assert tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the port's packing fed to the JAX kernel gives the JAX chain
    x = rng.normal(0, 1, (1, 256, c)).astype(np.float32)
    got = np.asarray(pallas_mrf.mrf_stage_fused(
        jnp.asarray(x.transpose(0, 2, 1)), *(jnp.asarray(a.numpy()) for a in (p3, p7, p11)),
        jnp.asarray(pbias.numpy()), t_tile=256, dtype=jnp.float32,
        interpret=True)).transpose(0, 2, 1)
    want = np.asarray(_xla_stage(stage, jnp.asarray(x)))
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def test_resblock_modules_equal_the_packed_plain_stage():
    """The CPU path of the generators (the ResBlock1 modules) and the plain
    version of the kernel compute the same stage."""
    rng = np.random.default_rng(3)
    blocks = _port_blocks(_make_stage(rng, 64), 64)
    x = torch.from_numpy(rng.normal(0, 1, (2, 64, 90)).astype(np.float32))
    (w3, w7, w11), bias = pack_mrf_weights(blocks)
    with torch.no_grad():
        modules = sum(b(x) for b in blocks) / 3
        packed = mrf_stage_fused(x, w3, w7, w11, bias)
    assert torch.allclose(modules, packed, rtol=0, atol=2e-6 * modules.abs().max().item())


def test_stage_halo_within_budget():
    assert stage_halo(KS, DS) == 60 == pallas_mrf.stage_halo(KS, DS)
    assert stage_halo(KS, DS) <= HALO == pallas_mrf.HALO


def _meta_operands(c=32, t=256):
    mats = [torch.empty(6, c, k * c, device="meta") for k in KS]
    return torch.empty(1, c, t, device="meta"), mats, torch.empty(18, c, 1, device="meta")


@pytest.mark.parametrize("kwargs,match", [
    ({"dilations": ((9, 9, 9),) * 3}, "halo"),
    ({"kernel_sizes": (3, 7, 13)}, "odd kernel sizes"),
    ({"kernel_sizes": (3, 6, 11)}, "odd kernel sizes"),
    ({"dilations": ((1, 3),) * 3}, "three dilations"),
    ({"dtype": torch.float16}, "float32/bfloat16"),
    ({}, "unsupported device"),
], ids=["receptive_field", "k13", "even_k", "two_dilations", "fp16", "not_cuda"])
def test_refuses_what_the_kernel_does_not_take(kwargs, match):
    """Off the CPU nothing runs plain: every refused shape raises, and a
    tensor of another device than the card raises too."""
    x, mats, bias = _meta_operands()
    with pytest.raises(ValueError, match=match):
        mrf_stage_fused(x, *mats, bias, **kwargs)


def test_refuses_other_widths_and_weights_that_do_not_fit():
    x, mats, bias = _meta_operands(c=96)
    with pytest.raises(ValueError, match="C in"):
        mrf_stage_fused(x, *mats, bias)
    x, mats, bias = _meta_operands()
    with pytest.raises(ValueError, match="do not fit"):
        mrf_stage_fused(x, mats[1], mats[1], mats[2], bias)


def test_a_cuda_call_without_a_compiler_raises_rather_than_running_plain():
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc") or \
            torch.cuda.is_available():
        pytest.skip("a CUDA toolkit or card is here: the build can run")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_libraries(("mrf",))
