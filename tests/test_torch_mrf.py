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
* packing: exact (the same numbers moved), both `pack_mrf_weights` and the
  kernel's stream built from it (`pack_mrf_kernel_weights`, fp32 as TF32 hi
  + lo planes), and the generators' per-stage pack caches (`MRFStages`).
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
from visual_onoma_to_wave_tpu_torch.ops import mrf as mrf_ops
from visual_onoma_to_wave_tpu_torch.models import build_istftnet, get_vocoder
from visual_onoma_to_wave_tpu_torch.ops.convnext import tf32_round
from visual_onoma_to_wave_tpu_torch.ops.mrf import (
    HALO,
    kernel_tile,
    kernel_weights_numel,
    mrf_route,
    mrf_stage_fused,
    pack_mrf_kernel_weights,
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


def _unpack_kernel_weights(packed: torch.Tensor, C: int, k: int) -> torch.Tensor:
    """The inverse of `pack_mrf_kernel_weights` for one branch: (6, C, k*C),
    fp32 as hi + lo, the bf16 padding columns dropped."""
    nt, kc, kcp = kernel_tile(C, packed.dtype)
    ck, split = 16 // packed.element_size(), 2 if packed.dtype == torch.float32 else 1
    planes = packed.reshape(6, C // nt, C // kc, k, split, kcp // ck, nt // 8, 8, ck)
    planes = planes.sum(4) if split == 2 else planes[:, :, :, :, 0]
    # (.., K groups, N cores, 8 rows, ck) -> (.., N, K)
    blocks = planes.permute(0, 1, 2, 3, 5, 6, 4, 7).reshape(6, C // nt, C // kc, k, nt, kcp)
    blocks = blocks[..., :kc]                          # [conv, co tile, ci chunk, j, co, ci]
    return blocks.permute(0, 1, 4, 3, 2, 5).reshape(6, C, k * C)


def _descriptor_read(plane: torch.Tensor, nt: int, n: int, kk: int) -> torch.Tensor:
    """Element (row n, column kk) of one (NT, KCP) plane read as the kernel's
    wgmma B descriptor addresses it: core matrices 128 bytes apart along N,
    NT * 16 bytes (`lbo`) apart along K, 16 bytes a row."""
    size = plane.element_size()
    ck = 16 // size
    byte = (kk // ck) * nt * 16 + (n // 8) * 128 + (n % 8) * 16 + (kk % ck) * size
    return plane[byte // size]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("c", [8, 16, 32, 64, 256])
def test_kernel_weights_unpack_to_the_packed_matrices(c, dtype):
    """`pack_mrf_kernel_weights` moves `pack_mrf_weights`'s numbers (rounded
    to the operand type) and nothing else: undone, it gives the (6, C, k*C)
    matrices exactly, and each plane holds tap j's A_j^T where the kernel's
    descriptors read it (bf16 C 8: zero columns past the 8 channels)."""
    g = torch.Generator().manual_seed(c)
    mats = [torch.randn(6, c, k * c, generator=g) for k in KS]
    packed = pack_mrf_kernel_weights(mats, dtype)
    for a, p, k in zip(mats, packed, KS):
        assert p.dtype == dtype and p.is_contiguous()
        assert p.numel() == kernel_weights_numel(c, k, dtype)
        assert torch.equal(_unpack_kernel_weights(p, c, k), a.to(dtype).to(p.dtype))
        nt, kc, kcp = kernel_tile(c, dtype)
        split = 2 if dtype == torch.float32 else 1
        planes = p.reshape(6, c // nt, c // kc, k, split, nt * kcp)
        for conv, nc, ch, j in ((0, 0, 0, 0), (5, c // nt - 1, c // kc - 1, k - 1)):
            plane = planes[conv, nc, ch, j, 0]
            for n, kk in ((0, 0), (nt - 1, kcp - 1), (nt // 2 + 1, kcp // 2 + 1)):
                want = (a[conv, nc * nt + n, j * c + ch * kc + kk].to(dtype) if kk < kc
                        else torch.zeros((), dtype=dtype))
                got = _descriptor_read(plane, nt, n, kk)
                if dtype == torch.float32:   # the hi plane: tf32 of the weight
                    want = tf32_round(want.reshape(1))[0]
                assert got == want, (conv, nc, ch, j, n, kk)


def test_kernel_weights_fp32_split_reproduces_each_weight():
    """fp32 planes: hi = tf32 (low 13 bits zero), hi + lo == w exactly, and
    with lo as the tensor cores read it (truncated to TF32) hi + lo is w to
    2^-21 relative: the remainder 3xTF32 leaves is that of lo's truncation."""
    g = torch.Generator().manual_seed(7)
    c = 64
    mats = [torch.randn(6, c, k * c, generator=g) * 0.05 for k in KS]
    for a, p, k in zip(mats, pack_mrf_kernel_weights(mats), KS):
        nt, kc, kcp = kernel_tile(c, torch.float32)
        hi, lo = p.reshape(-1, 2, nt * kcp).unbind(1)
        assert not bool((hi.view(torch.int32) & 0x1FFF).any())
        w = _unpack_kernel_weights(p, c, k)
        assert torch.equal(w, a)
        lo_tc = (lo.contiguous().view(torch.int32) & -0x2000).view(torch.float32)
        seen = torch.stack([hi, lo_tc], 1).reshape(-1)
        approx = _unpack_kernel_weights(seen, c, k)
        assert bool(((approx - a).abs() <= 2.0 ** -21 * a.abs()).all())
        assert not torch.equal(approx, a)     # the truncation does show


@pytest.mark.parametrize("family", ["istftnet", "hifigan"])
def test_stage_packs_follow_weight_changes(family):
    """A generator's MRF stages are packed once per operand type, again only
    after a weight changes (`load_state_dict` bumps the versions), and the
    cached stream is the packing of the current weights."""
    if family == "istftnet":
        g = build_istftnet("melrate", upsample_initial_channel=32)
        stage = g._stage_blocks(0)
    else:
        g = get_vocoder("HiFi-GAN", upsample_initial_channel=32)
        stage = g.resblocks[0:3]
    first = g._mrf.packed(0, stage, torch.float32)
    assert g._mrf.packed(0, stage, torch.float32) is first
    g.load_state_dict({k: v + 1.0 for k, v in g.state_dict().items()})
    again = g._mrf.packed(0, stage, torch.float32)
    assert again is not first
    assert torch.equal(again[1], first[1] + 1.0)
    mats, _ = pack_mrf_weights(stage)
    for got, want in zip(again[2], pack_mrf_kernel_weights(mats)):
        assert torch.equal(got, want)
    bf16 = g._mrf.packed(0, stage, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in bf16[2])
    assert g._mrf.packed(0, stage, torch.bfloat16) is bf16


def test_hifigan_resblock1_stages_on_the_cpu_run_the_modules():
    """Off the card the HiFi-GAN generator's stages are the modules averaged,
    as before the kernel took them on the card: V1 / V2 go through
    `MRFStages`, V3 (ResBlock2) keeps its own loop."""
    torch.manual_seed(0)
    mel = torch.randn(1, 9, 80)
    for preset in ("HiFi-GAN", "HiFi-GAN-v3"):
        g = get_vocoder(preset, upsample_initial_channel=32).eval()
        assert (g._mrf is None) == (preset == "HiFi-GAN-v3")
        with torch.no_grad():
            x = g.conv_pre(mel.transpose(1, 2))
            n = g.num_kernels
            for i, up in enumerate(g.ups):
                x = up(torch.nn.functional.leaky_relu(x, 0.1))
                x = sum(b(x) for b in g.resblocks[i * n:(i + 1) * n]) / n
            want = torch.tanh(g.conv_post(torch.nn.functional.leaky_relu(x, 0.01)))[:, 0]
            before = mrf_stage_fused.launches
            assert torch.allclose(g(mel), want, rtol=0, atol=1e-6)
            assert mrf_stage_fused.launches == before


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
    packed = [torch.empty(kernel_weights_numel(32, k, torch.float32), device="meta") for k in KS]
    with pytest.raises(ValueError, match="packed weights"):   # packed for other kernel sizes
        mrf_stage_fused(x, *mats, bias, packed=packed[::-1])
    with pytest.raises(ValueError, match="packed weights"):   # packed in another type
        mrf_stage_fused(x, *mats, bias, dtype=torch.bfloat16, packed=packed)


def test_a_cuda_call_without_a_compiler_raises_rather_than_running_plain():
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc") or \
            torch.cuda.is_available():
        pytest.skip("a CUDA toolkit or card is here: the build can run")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build_libraries(("mrf",))
    # the one-pass route (bf16 at C <= 64) loads the same library
    assert mrf_route(32, torch.bfloat16) == "onepass"
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mrf_ops._load_library()
