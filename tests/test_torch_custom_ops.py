"""The kernels' custom ops (`votw::attention_core`, `votw::mrf_stage_fused`,
`votw::convnext_block`) on the CPU.

`torch.library.opcheck` holds each op's schema, its CPU implementation (the
plain version) and its fake implementation (the output's shape and dtype,
what `torch.export` traces with) to each other, dynamic shapes included;
each op's output equals its plain version bit for bit; the wrappers refuse a
device other than the CPU and the card. The CUDA implementations launch the
kernels and are held to the same plain versions on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu_torch.models.hifigan import ResBlock1
from visual_onoma_to_wave_tpu_torch.ops.attention import (
    attention_core,
    attention_core_reference,
)
from visual_onoma_to_wave_tpu_torch.ops.convnext import (
    convnext_block,
    convnext_block_reference,
)
from visual_onoma_to_wave_tpu_torch.ops.mrf import (
    DILATIONS,
    KERNEL_SIZES,
    mrf_stage_fused,
    mrf_stage_fused_reference,
    pack_mrf_weights,
)


def _attention_args(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(2, 7, 2 * 8, generator=g) for _ in range(3))
    mask = torch.tensor([[False] * 5 + [True] * 2, [False] * 7])
    return (q, k, v, mask, 2)


def _mrf_args(seed: int = 0):
    torch.manual_seed(seed)
    blocks = [ResBlock1(8, k, d) for k, d in zip(KERNEL_SIZES, DILATIONS)]
    mats, biases = pack_mrf_weights(blocks)
    x = torch.randn(2, 8, 20)
    return (x, *mats, biases, list(KERNEL_SIZES), [d for ds in DILATIONS for d in ds], None, [])


def _convnext_args(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    C, M, K = 8, 16, 7
    x = torch.randn(2, 11, C, generator=g)
    dw = torch.randn(K, 1, C, generator=g) * 0.3
    vec = [torch.randn(n, generator=g) * 0.1 for n in (C, C, C, M, C, C)]
    w1, w2 = torch.randn(C, M, generator=g) * 0.2, torch.randn(M, C, generator=g) * 0.2
    db, ls, lb, b1, b2, gamma = vec
    return (x, dw, db, ls + 1.0, lb, w1, b1, w2, b2, gamma, 1e-6, True, None)


CASES = {
    "attention_core": (torch.ops.votw.attention_core.default, _attention_args),
    "mrf_stage_fused": (torch.ops.votw.mrf_stage_fused.default, _mrf_args),
    "convnext_block": (torch.ops.votw.convnext_block.default, _convnext_args),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_opcheck_cpu_and_fake_implementations(name):
    op, make = CASES[name]
    torch.library.opcheck(op, make())


@pytest.mark.parametrize("name", sorted(CASES))
def test_fake_implementation_states_shape_and_dtype(name):
    from torch._subclasses.fake_tensor import FakeTensorMode

    op, make = CASES[name]
    args = make()
    real = op(*args)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else [mode.from_tensor(t) for t in a]
                     if isinstance(a, list) and a and isinstance(a[0], torch.Tensor) else a
                     for a in args]
        fake = op(*fake_args)
    assert fake.shape == real.shape and fake.dtype == real.dtype


def test_ops_equal_their_plain_versions():
    q, k, v, mask, h = _attention_args(1)
    np.testing.assert_array_equal(attention_core(q, k, v, mask, h).numpy(),
                                  attention_core_reference(q, k, v, mask, h).numpy())
    x, w3, w7, w11, b, ks, ds, _, _ = _mrf_args(1)
    np.testing.assert_array_equal(mrf_stage_fused(x, w3, w7, w11, b).numpy(),
                                  mrf_stage_fused_reference(x, w3, w7, w11, b).numpy())
    args = _convnext_args(1)
    np.testing.assert_array_equal(convnext_block(*args[:10]).numpy(),
                                  convnext_block_reference(*args[:10]).numpy())


def test_wrappers_refuse_other_devices():
    q, k, v, mask, h = (t.to("meta") if isinstance(t, torch.Tensor) else t
                        for t in _attention_args())
    with pytest.raises(ValueError, match="unsupported device"):
        attention_core(q, k, v, mask, h)
    x, w3, w7, w11, b = (t.to("meta") for t in _mrf_args()[:5])
    with pytest.raises(ValueError, match="C in|unsupported device"):
        mrf_stage_fused(x, w3, w7, w11, b)
    args = [t.to("meta") if isinstance(t, torch.Tensor) else t for t in _convnext_args()]
    with pytest.raises(ValueError, match="unsupported device|C in"):
        convnext_block(*args[:10])


def test_cpu_calls_that_need_a_gradient_take_the_plain_version():
    """The ops have no backward: a CPU call that needs a gradient runs the
    plain version with autograd instead."""
    q, k, v, mask, h = _attention_args()
    q.requires_grad_(True)
    attention_core(q, k, v, mask, h).sum().backward()
    assert q.grad is not None and torch.isfinite(q.grad).all()
