"""The mel frontend kernel's FFT (`csrc/mel_frontend.cu`, B3), emulated on
the CPU in numpy float64, index for index.

The kernel runs a Stockham FFT over the n_fft / 2 complex points z[n] =
x[2n] + i x[2n + 1] of each clipped, windowed frame: the passes of
`ops/mel.py::fft_plan` (one radix-2 or radix-4 pass where log2(n_fft / 2)
is not a multiple of 3, then radix-8 passes), each lane holding
`LANE_VALUES` complex values in registers. Pass p (radix R, stride Ns)
gives butterfly j the inputs z[j + r N / R], multiplies input r by the
table's W_{Ns R}^{(j mod Ns) r}, takes an R-point DFT and writes output q to
(j div Ns) Ns R + (j mod Ns) + q Ns: through the frame's exchange buffer,
whose element e sits at slot e + e // 8 (one pad slot per 8), except the
first pass, which reads the frame from device memory, and the last, whose
outputs stay in registers. In the last pass a lane takes butterflies j and
M - j (M = N / 8; lane 0 takes 0 and M / 2), so that it holds z[k] and z[N -
k] of each bin pair it splits into X[k] and X[N - k]. After the power of a
bin, the kernel goes to fp32: the magnitude (sqrtf), log(P + 1e-8) (logf,
summed in float64), the mel product (fp32 FMA) and its log.

`emulated_fft` and `emulated_spectrum` repeat all of that over numpy arrays shaped (frames,
lanes, values), with the twiddles of `twiddle_table`, a NaN-filled exchange
buffer (a read of a slot that no lane wrote poisons the result) and a check
that every slot and every bin is written exactly once. Held here:
  * the spectrum against `np.fft.rfft` within 1e-12 x max |X| of each frame,
    for every n_fft the kernel takes (16 ... 2048);
  * the exchange accesses against a model of the shared-memory banks: every
    store and every gather before the last pass is conflict-free, and the
    last pass's mirrored gathers (butterflies M - j) take 2 wavefronts where
    1 would do in each quarter-warp, 1.125x the ideal over the FFT at n_fft 1024;
  * the fp32 stage after the power: log-mel within 1e-5 of the float64
    log-mel and within chip_smoke's `check_mel_frontend` bounds of
    `mel_frontend_reference`, over `chip_smoke.mel_cases()`;
  * one case against the TPU kernel `pallas_logmel_energy` in interpret mode.
Beside it: the block geometry that `ops/mel.py` mirrors (and chip_smoke's
n_fft sweep sizes its clips by) is the kernel source's own, and chip_smoke's
`parse_ptxas` reads registers and spills per instantiation.
"""
from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from visual_onoma_to_wave_tpu.ops.pallas_mel import pallas_logmel_energy
from visual_onoma_to_wave_tpu_torch.ops import cuda_build, mel
from visual_onoma_to_wave_tpu_torch.ops.mel import (
    LANE_VALUES,
    MAX_N_FFT,
    MIN_N_FFT,
    _host_constants,
    block_frames,
    fft_plan,
    mel_frontend_reference,
    twiddle_table,
)

N_FFTS = [1 << e for e in range(MIN_N_FFT.bit_length() - 1, MAX_N_FFT.bit_length())]
SR, HOP, N_MELS = chip_smoke.SR, chip_smoke.MEL_HOP, 80


def pad(e):
    """Exchange-buffer slot of element e: one pad slot after every 8."""
    return e + (e >> 3)


def lanes(n_fft: int) -> tuple[int, int, int]:
    """(N, values a lane holds, lanes a frame)."""
    n = n_fft // 2
    values = min(LANE_VALUES, n)
    return n, values, n // values


def butterflies(n_fft: int, p: int) -> np.ndarray:
    """(lanes, butterflies a lane) of pass p: lane t takes t + b * lanes,
    except in the last pass (M > 1), where it takes t and M - t (lane 0: 0
    and M / 2)."""
    n, values, tpf = lanes(n_fft)
    plan = fft_plan(n_fft)
    radix = plan[p][0]
    t = np.arange(tpf)[:, None]
    b = np.arange(values // radix)[None, :]
    m = n // 8
    if p == len(plan) - 1 and m > 1:
        return np.where(b == 0, t, np.where(t == 0, m // 2, m - t))
    return t + b * tpf


def dft(v: list[np.ndarray]) -> list[np.ndarray]:
    """The kernel's in-register R-point DFT (R = len(v)), op for op."""
    if len(v) == 2:
        return [v[0] + v[1], v[0] - v[1]]
    if len(v) == 4:
        d0, d1, d2, d3 = v[0] + v[2], v[0] - v[2], v[1] + v[3], v[1] - v[3]
        d3 = d3.imag - 1j * d3.real                                  # -i d3
        return [d0 + d2, d1 + d3, d0 - d2, d1 - d3]
    c = np.sqrt(0.5)
    a = [v[k] + v[k + 4] for k in range(4)]
    b = [v[k] - v[k + 4] for k in range(4)]
    b[1] = (b[1].real + b[1].imag) * c + 1j * ((b[1].imag - b[1].real) * c)   # W8
    b[2] = b[2].imag - 1j * b[2].real                                       # W8^2
    b[3] = (b[3].imag - b[3].real) * c + 1j * (-(b[3].real + b[3].imag) * c)  # W8^3
    even, odd = dft(a), dft(b)
    return [x for pair in zip(even, odd) for x in pair]


def emulated_fft(frames: np.ndarray, n_fft: int, writes: list | None = None) -> np.ndarray:
    """The kernel's passes over windowed frames (F, n_fft) float64. Returns
    the last pass's registers (F, lanes, values): lane t's butterfly b at
    [..., b * 8 + q] = Z[j_b + q M]. `writes` collects, per exchange, the
    elements each lane stores (lanes, stores) for the bank model."""
    n, values, tpf = lanes(n_fft)
    plan = fft_plan(n_fft)
    table = twiddle_table(n_fft)
    table = table[:, 0] + 1j * table[:, 1]
    z = frames[:, 0::2] + 1j * frames[:, 1::2]
    buf = np.full((frames.shape[0], pad(n - 1) + 1), np.nan + 0j)
    offset = n
    for p, (radix, stride) in enumerate(plan):
        j = butterflies(n_fft, p)                                    # (lanes, B)
        src = j[:, :, None] + np.arange(radix) * (n // radix)        # (lanes, B, R)
        v = z[:, src] if p == 0 else buf[:, pad(src)]
        if stride > 1:
            rows = offset + (np.arange(1, radix) - 1)[None, None, :] * stride
            v[..., 1:] = v[..., 1:] * table[rows + (j % stride)[:, :, None]]
            offset += (radix - 1) * stride
        v = np.stack(dft([v[..., r] for r in range(radix)]), axis=-1)
        if p < len(plan) - 1:
            dst = (j // stride * stride * radix + j % stride)[:, :, None] + \
                np.arange(radix) * stride
            assert np.array_equal(np.sort(dst.ravel()), np.arange(n)), "a slot written twice"
            buf[:, pad(dst)] = v
            if writes is not None:
                writes.append(dst.reshape(tpf, -1))
        assert not np.isnan(v).any(), f"pass {p} read a slot no lane wrote"
    return v.reshape(frames.shape[0], tpf, values)


# lane 0's register moves before the split (it holds the self-paired
# butterflies 0 and M / 2): register i takes register LEAD_MOVES[i]
LEAD_MOVES = np.array([0, 1, 2, 3, 8, 9, 10, 11, 12, 13, 14, 15, 5, 6, 7, 0])


def split_slots(n_fft: int):
    """Per slot of the split: which registers hold A = Z[k] and B = Z[N - k]
    (after lane 0's moves) and which k it computes: (a_reg, b_reg, k), the
    last (lanes, slots)."""
    n, values, tpf = lanes(n_fft)
    m = n // 8
    t = np.arange(tpf)[:, None]
    if m == 1:                                        # n_fft 16: one butterfly
        q = np.arange(4)[None, :]
        return q, (8 - q) & 7, q
    q = np.arange(8)[None, :]
    k = np.where(t == 0, np.where(q < 4, q * m, m // 2 + (q - 4) * m), t + q * m)
    return q, 15 - q, k


def emulated_spectrum(frames: np.ndarray, n_fft: int) -> np.ndarray:
    """rfft of windowed frames (F, n_fft) float64 as the kernel computes it:
    (F, n_fft / 2 + 1) complex."""
    n = n_fft // 2
    regs = emulated_fft(frames, n_fft)
    half_bin = regs[:, 0, 4].copy()                   # lane 0's z[N / 2]
    if n // 8 > 1:
        regs[:, 0] = regs[:, 0, LEAD_MOVES]
    a_reg, b_reg, k = split_slots(n_fft)
    table = twiddle_table(n_fft)
    w = table[k, 0] + 1j * table[k, 1]
    A = np.take_along_axis(regs, np.broadcast_to(a_reg, k.shape)[None], axis=2)
    B = np.take_along_axis(regs, np.broadcast_to(b_reg, k.shape)[None], axis=2)
    s = (A.real + B.real) + 1j * (A.imag - B.imag)               # A + conj B
    d = (A.real - B.real) + 1j * (A.imag + B.imag)               # A - conj B
    wo = (w.real * d.imag + w.imag * d.real) + 1j * (w.imag * d.imag - w.real * d.real)
    out = np.full((frames.shape[0], n + 1), np.nan + 0j)
    written = np.zeros(n + 1, int)
    out[:, k] = 0.5 * (s + wo)
    out[:, n - k] = 0.5 * np.conj(s - wo)
    np.add.at(written, k.ravel(), 1)
    np.add.at(written, (n - k).ravel(), 1)
    out[:, n // 2] = np.conj(half_bin)                # lane 0's bin N / 2
    written[n // 2] += 1
    assert (written == 1).all(), f"bins written {np.unique(written)} times"
    return out


def windowed_frames(prepadded: np.ndarray, n_fft: int, hop: int, win_length: int) -> np.ndarray:
    """Clipped, windowed frames (B * T, n_fft) float64, as the kernel forms
    them: fp32 sample times fp32 window, exact in float64."""
    window = _host_constants(n_fft, win_length, N_MELS, SR, 0.0, 8000.0)[0]
    x = np.clip(prepadded, -1.0, 1.0).astype(np.float64)
    t = (x.shape[1] - n_fft) // hop + 1
    idx = np.arange(t)[:, None] * hop + np.arange(n_fft)
    return (x[:, idx] * window.astype(np.float64)).reshape(-1, n_fft), t


def emulated_mel_frontend(prepadded: np.ndarray, n_fft: int = 1024, hop: int = HOP,
                          win_length: int = 1024):
    """The kernel's outputs (logmel (B, n_mels, T), energy, power_sum,
    log_power_sum (B, T)) with its stage after the power in fp32: magnitude
    0.5 sqrtf(4P), logf(P + 1e-8) summed in float64, the mel product as fp32
    FMAs over each filter's bins in order, logf of its max with 1e-5."""
    frames, t = windowed_frames(prepadded, n_fft, hop, win_length)
    spec = emulated_spectrum(frames, n_fft)
    q = 4.0 * (spec.real ** 2 + spec.imag ** 2)                   # the kernel's 4 P
    qf = q.astype(np.float32)
    mag = np.float32(0.5) * np.sqrt(qf)
    log_p = np.log((np.float32(0.25) * qf.astype(np.float64) + np.float32(1e-8))
                   .astype(np.float32))
    _, _, index, weights, _ = _host_constants(n_fft, win_length, N_MELS, SR, 0.0, 8000.0)
    acc = np.zeros((frames.shape[0], N_MELS), np.float32)
    for m, (lo, hi, off) in enumerate(index.T):
        for i in range(hi - lo):
            acc[:, m] = (weights[off + i].astype(np.float64) * mag[:, lo + i]
                         + acc[:, m]).astype(np.float32)
    logmel = np.log(np.maximum(acc, np.float32(1e-5)))
    power = 0.25 * q.sum(-1)
    b = prepadded.shape[0]
    return (logmel.reshape(b, t, N_MELS).transpose(0, 2, 1),
            np.sqrt(power).astype(np.float32).reshape(b, t),
            power.astype(np.float32).reshape(b, t),
            log_p.astype(np.float64).sum(-1).astype(np.float32).reshape(b, t))


def logmel_float64(prepadded: np.ndarray, n_fft: int, hop: int, win_length: int) -> np.ndarray:
    """log-mel in float64 throughout (np.fft.rfft), the arbiter."""
    frames, t = windowed_frames(prepadded, n_fft, hop, win_length)
    fb = _host_constants(n_fft, win_length, N_MELS, SR, 0.0, 8000.0)[4].astype(np.float64)
    mel = np.abs(np.fft.rfft(frames, axis=-1)) @ fb
    return np.log(np.maximum(mel, 1e-5)).reshape(prepadded.shape[0], t, -1).transpose(0, 2, 1)


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_fft_matches_numpy_rfft(n_fft):
    rng = np.random.default_rng(n_fft)
    frames = rng.uniform(-1.0, 1.0, (6, n_fft))
    frames[1] = 0.0
    frames[2] = np.cos(2 * np.pi * 3 * np.arange(n_fft) / n_fft)   # a pure bin
    frames[3, ::7] = 1e-6                                         # a tiny, sparse frame
    got = emulated_spectrum(frames, n_fft)
    ref = np.fft.rfft(frames, axis=-1)
    err = np.abs(got - ref).max(-1)
    assert (err <= 1e-12 * np.maximum(np.abs(ref).max(-1), 1e-300)).all(), err


def test_twiddle_table_rows_follow_the_plan():
    n_fft = 2048
    table = twiddle_table(n_fft)
    w = table[:, 0] + 1j * table[:, 1]
    n = n_fft // 2
    assert np.allclose(w[:n], np.exp(-2j * np.pi * np.arange(n) / n_fft), atol=1e-15)
    row = n
    for radix, stride in fft_plan(n_fft)[1:]:
        for r in range(1, radix):
            s = np.arange(stride)
            assert np.allclose(w[row:row + stride], np.exp(-2j * np.pi * s * r / (stride * radix)),
                               atol=1e-15)
            row += stride
    assert row == len(table)


def wavefronts(slots: np.ndarray) -> int:
    """Shared-memory wavefronts of one warp's 16-byte accesses to complex
    slots (32,): each quarter-warp is one wavefront unless two of its lanes
    hit different slots of one 16-byte bank group (slot mod 8)."""
    total = 0
    for quarter in slots.reshape(4, 8):
        groups: dict[int, set] = {}
        for s in quarter.tolist():
            groups.setdefault(s % 8, set()).add(s)
        total += max(len(g) for g in groups.values())
    return total


def warp_accesses(n_fft: int):
    """(kind, pass, slots (32,)) for every exchange instruction of warp 0
    at n_fft >= 1024 (a frame spans whole warps there)."""
    n, values, tpf = lanes(n_fft)
    writes: list = []
    emulated_fft(np.zeros((1, n_fft)), n_fft, writes)
    for p, dst in enumerate(writes):
        for col in range(dst.shape[1]):
            yield "store", p, pad(dst[:32, col])
    for p, (radix, _) in enumerate(fft_plan(n_fft)[1:], start=1):
        j = butterflies(n_fft, p)[:32]
        for b in range(j.shape[1]):
            for r in range(radix):
                yield "gather", p, pad(j[:, b] + r * (n // radix))


@pytest.mark.parametrize("n_fft", [1024, 2048])
def test_exchange_buffer_is_free_of_bank_conflicts_but_for_the_mirrored_gathers(n_fft):
    last = len(fft_plan(n_fft)) - 1
    total = ideal = 0
    for kind, p, slots in warp_accesses(n_fft):
        w = wavefronts(slots)
        total, ideal = total + w, ideal + 4
        if kind == "store" or p < last:
            assert w == 4, (kind, p, slots)
        else:
            assert w <= 8, (kind, p, slots)
    assert total <= 1.125 * ideal, total / ideal


@pytest.mark.parametrize("name,prepadded,win",
                         [pytest.param(*case, id=case[0]) for case in chip_smoke.mel_cases()])
def test_fp32_after_the_power_holds_float64_and_the_plain_version(name, prepadded, win):
    got = emulated_mel_frontend(prepadded, win_length=win)
    exact = logmel_float64(prepadded, 1024, HOP, win)
    assert np.abs(got[0] - exact).max() <= chip_smoke.MEL_FLOAT64_ATOL, np.abs(got[0] - exact).max()
    ref = [t.numpy() for t in mel_frontend_reference(torch.from_numpy(prepadded),
                                                     win_length=win)]
    chip_smoke.check_mel_frontend(name, got, ref, loose=name == "full_scale")


def test_matches_the_jax_kernel_in_interpret_mode():
    name, prepadded, win = chip_smoke.mel_cases()[0]
    ref_mel, ref_energy = pallas_logmel_energy(jnp.asarray(prepadded), 1024, HOP, win, N_MELS,
                                               SR, interpret=True)
    logmel, energy, _, _ = emulated_mel_frontend(prepadded, win_length=win)
    assert np.abs(logmel - np.asarray(ref_mel)).max() <= chip_smoke.MEL_ATOL
    assert np.abs(energy / np.asarray(ref_energy) - 1.0).max() <= chip_smoke.SUM_RTOL


@pytest.mark.parametrize("name", ["THREADS", "ROUNDS", "LANE_VALUES"])
def test_block_geometry_is_the_kernel_sources(name):
    src = (cuda_build.CSRC / "mel_frontend.cu").read_text()
    found = re.findall(rf"^constexpr int {name} = (\d+);", src, flags=re.M)
    assert found == [str(getattr(mel, name))], (name, found)


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_sweep_blocks_case_spans_three_blocks_and_a_ragged_tail(n_fft):
    blocks = [x for name, x, n, hop in chip_smoke.mel_sweep_cases()
              if n == n_fft and name.endswith("_blocks")]
    frames = (blocks[0].shape[1] - n_fft) // (n_fft // 4) + 1
    assert frames // block_frames(n_fft) == 3 and frames % block_frames(n_fft) > 0


def test_parse_ptxas_reads_each_instantiation():
    name = "_ZN12_GLOBAL__N_119mel_frontend_kernelILi{}EEEvPKfiiiPK7double2S2_PKiS2_iPfS8_S8_S8_"
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{name.format(9)}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name.format(9)}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 126 registers, used 1 barriers, 400 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{name.format(3)}' for 'sm_90a'",
        f"ptxas info    : Function properties for {name.format(3)}",
        "    16 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 400 bytes cmem[0]"])
    assert chip_smoke.parse_ptxas(log) == {
        1024: {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 126},
        16: {"stack": 16, "spill_stores": 8, "spill_loads": 4, "registers": 40}}
