"""The yardstick's arithmetic, frozen here: the card's peaks, each kernel's
operations and bytes, and the sum of a request's model FLOPs at the peaks
(each model family counts its own FLOPs in `reference/<family>.py`).

Copied from `chip_smoke.py` (`bound`, `attention_costs`, `mrf_cost`,
`convnext_cost` and the peak constants), with one change: 32-bit float work
counts against the TF32 tensor-core peak (495 TFLOP/s), since the port's
kernels run fp32 as 3xTF32 on the tensor cores, and bf16 work against 989.
A share of these bounds cannot pass 100% whatever a later kernel does.

Peaks: NVIDIA H100 SXM data sheet, dense, at the full 700 W. Bytes count
each input once and each output once.
"""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the card could take: operations over the dtype's peak
    or bytes over the memory rate, whichever is larger."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def attention_cost(batch: int, frames: int, heads: int, head_dim: int, valid_keys: int,
                   dtype: str) -> tuple[float, float]:
    """(FLOPs, bytes) of one masked attention call over (batch, frames) rows:
    both products over the keys each query may see (4 T Tk dk per item and
    head, Tk summed over the batch as `valid_keys`); Q and the byte mask
    read, the context written, and the valid keys' rows of K and V read."""
    s = DTYPE_BYTES[dtype]
    flops = 4.0 * heads * head_dim * frames * valid_keys
    q = batch * frames * heads * head_dim * s
    return flops, q + batch * frames + q + 2.0 * valid_keys * heads * head_dim * s


def mrf_stage_cost(batch: int, channels: int, frames: int, dtype: str,
                   kernel_sizes=(3, 7, 11), dilations=((1, 3, 5),) * 3) -> tuple[float, float]:
    """(FLOPs, bytes) of one MRF stage: every branch's two convs per dilation
    (2 k C^2 multiply-adds a frame each); x read and the output written in
    the stage's dtype, the weights read once in it, the fp32 biases once."""
    s = DTYPE_BYTES[dtype]
    taps = sum(2 * len(ds) * k for k, ds in zip(kernel_sizes, dilations))
    flops = 2.0 * taps * channels * channels * batch * frames
    weights = taps * channels * channels * s
    biases = sum(2 * len(ds) for ds in dilations) * channels * 4
    return flops, 2.0 * batch * channels * frames * s + weights + biases


def convnext_block_cost(batch: int, frames: int, dim: int, inner: int, kernel: int,
                        dtype: str) -> tuple[float, float]:
    """(FLOPs, bytes) of one ConvNeXt block: the two products and the
    depthwise conv a frame; x read and y written in the dtype, the conv and
    product weights once in it, the per-channel vectors once in fp32."""
    s = DTYPE_BYTES[dtype]
    flops = batch * frames * (4.0 * dim * inner + 2.0 * kernel * dim)
    weights = (kernel * dim + 2 * dim * inner) * s + (5 * dim + inner) * 4
    return flops, 2.0 * batch * frames * dim * s + weights


# ----------------------------------------------------------- model FLOPs
def conv_flops(frames: float, c_in: int, c_out: int, kernel: int) -> float:
    return 2.0 * frames * c_in * c_out * kernel


def request_time_at_peak(config: dict, families: dict, chars: int, frames: int) -> float:
    """Seconds one request's model FLOPs take at the peaks of their dtypes;
    each family's `flops` (in `reference/<family>.py`) counts its part."""
    ac = config["acoustic"]
    parts = [(families["acoustic"].flops(ac, chars, frames), ac["dtype"])]
    parts += families["vocoder"].flops(config["vocoder"], frames)
    return sum(f / PEAK_FLOPS[dt] for f, dt in parts)
