#!/usr/bin/env python3
"""Where the bf16 acoustic model's gap between the attention kernel and its
plain version comes from (chip_smoke phase 20's mel reading), on the card.

    python3 tools/bf16_attention_gap_torch.py [--seeds 0,1,2,3,4] [--out FILE]

For each seed s: the ICASSP acoustic model of chip_smoke (`icassp_acoustic`,
weights and batch of 16 from seed s) in bf16 compute, as
`train.compute_dtype: bfloat16` builds it, and in fp32 on the same weights.
One JSON line per seed, each comparison as `max` (max |a - b| / max |b|),
`mean` (mean |a - b| / mean |b|) and `differ` (the share of elements that
differ):

- `calls`: every attention call of one bf16 forward, on that call's own q,
  k, v and mask: the kernel (B1, `csrc/flash_mha.cu`) against
  `attention_core_reference` (`vs_plain`: P normalised in fp32, then rounded
  to bf16 for the product with V, JAX's bf16 chain), against
  `two_pass_reference` (`vs_emulation`: the kernel's own arithmetic, two
  passes over 64-key tiles that round P where JAX does) and against
  `unnormalised_reference` (`vs_one_pass`: the one-pass rounding B1 had
  before: per 64-key tile, exp(s - running max) rounded to bf16 for the
  product with V, the running sum over the unrounded values, the context
  times the sum's reciprocal at the end). A kernel nearer one emulation than
  the other names its rounding point;
- `block`: the first decoder FFT block on its own input, through the kernel
  against through the plain core, and the plain bf16 block against the
  fp32 block (bf16's own effect on one block);
- `mel`: the postnet mel teacher-forced with the kernel run's durations,
  through the kernels against through the plain core (phase 20's reading),
  and the plain bf16 mel against the fp32 mel.

Imports nothing of JAX; needs an NVIDIA GPU. Prints the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

KEY_TILE = 64   # the kernel's keys a tile (BLOCK_N)


def unnormalised_reference(q, k, v, key_pad_mask, n_head: int, tile: int = KEY_TILE):
    """B1's earlier one-pass bf16 rounding in plain PyTorch (module
    docstring): (B, T, H*dk) in q's dtype."""
    import torch

    B, T, HD = q.shape
    dk = HD // n_head
    qh, kh, vh = (x.reshape(B, T, n_head, dk).transpose(1, 2).float() for x in (q, k, v))
    s = (qh @ kh.transpose(-1, -2)) * (1.0 / dk ** 0.5)
    if key_pad_mask is not None:
        s = s.masked_fill(key_pad_mask[:, None, None, :], -torch.inf)
    m = torch.full(s.shape[:-1] + (1,), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros(B, n_head, T, dk, device=q.device)
    for j in range(0, T, tile):
        st = s[..., j:j + tile]
        # a tile with no valid key of the item is skipped, as the kernel skips it
        live = (st > -torch.inf).any(-1, keepdim=True)
        m_new = torch.where(live, torch.maximum(m, st.amax(-1, keepdim=True)), m)
        alpha = torch.where(live, torch.exp(m - m_new), torch.ones_like(m))
        p = torch.where(live, torch.exp(st - m_new), torch.zeros_like(st))
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(q.dtype).float() @ vh[..., j:j + tile, :]
        m = m_new
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    return (o * inv).transpose(1, 2).reshape(B, T, HD).to(q.dtype)


def two_pass_reference(q, k, v, key_pad_mask, n_head: int, tile: int = KEY_TILE):
    """The kernel's bf16 arithmetic in plain PyTorch: pass 1 the rows' max m
    and sum l online over the live tiles, pass 2 P = bf16(exp(s - m) / l)
    and a fresh P V sum a tile, the output rounded once. (B, T, H*dk) in q's
    dtype."""
    import torch

    B, T, HD = q.shape
    dk = HD // n_head
    qh, kh, vh = (x.reshape(B, T, n_head, dk).transpose(1, 2).float() for x in (q, k, v))
    s = sum(qh[..., d0:d0 + tile] @ kh[..., d0:d0 + tile].transpose(-1, -2)
            for d0 in range(0, dk, tile)) * (1.0 / dk ** 0.5)
    if key_pad_mask is not None:
        s = s.masked_fill(key_pad_mask[:, None, None, :], -torch.inf)
    m = torch.full(s.shape[:-1] + (1,), -torch.inf, device=q.device)
    l = torch.zeros_like(m)
    lives = []
    for j in range(0, T, tile):
        st = s[..., j:j + tile]
        live = (st > -torch.inf).any(-1, keepdim=True)
        m_new = torch.where(live, torch.maximum(m, st.amax(-1, keepdim=True)), m)
        l = torch.where(live, l * torch.exp(m - m_new)
                        + torch.exp(st - m_new).sum(-1, keepdim=True), l)
        m = m_new
        lives.append(live)
    inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
    o = torch.zeros(B, n_head, T, dk, device=q.device)
    for j, live in zip(range(0, T, tile), lives):
        p = (torch.exp(s[..., j:j + tile] - m) * inv).to(q.dtype).float()
        o = o + torch.where(live, p @ vh[..., j:j + tile, :], torch.zeros_like(o))
    return o.transpose(1, 2).reshape(B, T, HD).to(q.dtype)


def compare(a, b) -> dict:
    a, b = a.float(), b.float()
    d = (a - b).abs()
    return {"max": float(d.max() / b.abs().max().clamp_min(1e-30)),
            "mean": float(d.mean() / b.abs().mean().clamp_min(1e-30)),
            "differ": float((d > 0).float().mean())}


@contextlib.contextmanager
def recorded_attention(calls: list):
    """While the context lasts, every attention call of the acoustic model
    goes to the kernel as before and its inputs and output are kept."""
    import visual_onoma_to_wave_tpu_torch.models.layers as layers

    kernel = layers.attention_core

    def record(q, k, v, mask, n_head):
        out = kernel(q, k, v, mask, n_head)
        calls.append((q, k, v, mask, n_head, out))
        return out

    layers.attention_core = record
    try:
        yield
    finally:
        layers.attention_core = kernel


def one_seed(dev, seed: int) -> dict:
    import torch

    import chip_smoke
    from visual_onoma_to_wave_tpu_torch.models import VTTS
    from visual_onoma_to_wave_tpu_torch.models.layers import attention_core_reference

    model, batch = chip_smoke.icassp_acoustic(dev, seed)
    model16 = VTTS(n_vocab=64, n_audiotype=10, max_mel_len=chip_smoke.MAX_MEL,
                   dtype=torch.bfloat16)
    model16.load_state_dict(model.state_dict())
    model16 = model16.to(dev).eval()
    inputs = {k: batch[k] for k in ("audiotypes", "texts", "src_lens", "image_cells")}
    calls, block_in = [], []
    first = model16.decoder.layer_stack[0]
    hook = first.register_forward_pre_hook(lambda mod, args: block_in.append(args))
    with torch.inference_mode():
        with recorded_attention(calls):
            durations = model16(**inputs)["duration_rounded"]
        hook.remove()
        per_call = []
        for q, k, v, mask, n_head, out in calls:
            per_call.append({"T": q.shape[1], "dtype": str(q.dtype)[len("torch."):],
                             "vs_plain": compare(out, attention_core_reference(
                                 q, k, v, mask, n_head)),
                             "vs_emulation": compare(out, two_pass_reference(
                                 q, k, v, mask, n_head)),
                             "vs_one_pass": compare(out, unnormalised_reference(
                                 q, k, v, mask, n_head))})
        x, mask = block_in[0]
        kernel_block = first(x, mask)
        with chip_smoke.plain_attention():
            plain_block = first(x, mask)
            plain_mel = model16(**inputs, duration_targets=durations)["postnet_mel"]
        fp32_block = model.decoder.layer_stack[0](x, mask)
        kernel_mel = model16(**inputs, duration_targets=durations)["postnet_mel"]
        fp32_mel = model(**inputs, duration_targets=durations)["postnet_mel"]
    chip_smoke.zero_launch_counts()
    return {"metric": "bf16_attention_gap", "seed": seed, "calls": per_call,
            "block": {"kernel_vs_plain": compare(kernel_block, plain_block),
                      "plain_bf16_vs_fp32": compare(plain_block, fp32_block)},
            "mel": {"kernel_vs_plain": compare(kernel_mel, plain_mel),
                    "plain_bf16_vs_fp32": compare(plain_mel, fp32_mel)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2,3,4")
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    args = ap.parse_args(argv)

    import torch

    from visual_onoma_to_wave_tpu_torch.precision import pin_fp32

    if not torch.cuda.is_available():
        raise SystemExit("bf16_attention_gap_torch: needs an NVIDIA GPU")
    pin_fp32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    with open(args.out, "w") if args.out else contextlib.nullcontext() as out:
        for seed in (int(s) for s in args.seeds.split(",")):
            line = json.dumps({**one_seed(dev, seed), "card": card})
            for f in (sys.stdout, out):
                if f is not None:
                    print(line, file=f, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
