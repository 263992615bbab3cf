"""The port's kernel wrappers (`visual_onoma_to_wave_tpu_torch/ops/`).

No JAX here, so the file also runs on a machine with a GPU and no JAX:

    python -m pytest tests/test_torch_kernels.py -q     # on the card

On the CPU a wrapper takes its plain PyTorch version and counts no launch;
on any other non-CUDA device it raises. The tests marked `gpu` compare
each CUDA kernel with its plain version on the card and skip without one.
Tolerances: fp32 1e-5 absolute (summation order only); bf16 2e-2 absolute
plus one bf16 ulp relative (probabilities rounded at other points, both
results rounded to bf16).
"""
from __future__ import annotations

import pytest
import torch

from visual_onoma_to_wave_tpu_torch.ops.attention import attention_core, attention_core_reference


def _mask(lens, T, device=None) -> torch.Tensor:
    return torch.arange(T, device=device)[None, :] >= torch.tensor(lens, device=device)[:, None]


def test_cpu_tensors_take_the_plain_version():
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 10, 128, generator=g) for _ in range(3))
    mask = _mask([10, 4], 10)
    before = attention_core.launches
    out = attention_core(q, k, v, mask, 2)
    assert attention_core.launches == before     # no kernel launch counted
    assert torch.equal(out, attention_core_reference(q, k, v, mask, 2))


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty(2, 10, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention_core(q, q, q, None, 2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 0.0),
                                             (torch.bfloat16, 2e-2, 2.0 ** -7)])
@pytest.mark.parametrize("dk", [64, 128])
@pytest.mark.parametrize("T", [8, 100, 1000])
def test_attention_kernel_matches_plain(cuda, T, dk, dtype, atol, rtol):
    g = torch.Generator(device=cuda).manual_seed(T + dk)
    q, k, v = (torch.randn(3, T, 2 * dk, generator=g, device=cuda).to(dtype) for _ in range(3))
    mask = _mask([T, T // 3 + 1, 0], T, cuda)     # none, tail, fully padded
    before = attention_core.launches
    out = attention_core(q, k, v, mask, 2)
    ref = attention_core_reference(q, k, v, mask, 2)
    torch.cuda.synchronize()
    assert attention_core.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=atol)
    assert (out[2] == 0).all()


@pytest.mark.gpu
def test_attention_kernel_rejects_what_it_does_not_take(cuda):
    q = torch.randn(1, 8, 2 * 32, device=cuda)
    with pytest.raises(ValueError, match="dk in"):
        attention_core(q, q, q, None, 2)                    # dk 32
    with pytest.raises(ValueError, match="float32/bfloat16"):
        attention_core(*(torch.randn(1, 8, 128, device=cuda).half(),) * 3, None, 2)
