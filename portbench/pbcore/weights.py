"""Weights made from the seed, on the device, in a few large calls.

A list of (name, shape, kind, value) specs (each reference family's
`param_specs`) becomes a dict of float32 tensors: one normal draw for every
"normal" leaf, one uniform draw for every "uniform" leaf, from one
`torch.Generator` on `device`, then cut into leaves and scaled. The same
dict goes to the program (`load_state_dict`) and to the reference.
"""
from __future__ import annotations

import torch


def make(specs: list[tuple], seed: int, device: torch.device, stream: int = 0) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream) % 2 ** 63)
    out = {}
    for kind, draw in (("normal", torch.randn), ("uniform", torch.rand)):
        leaves = [s for s in specs if s[2] == kind]
        total = sum(_numel(s[1]) for s in leaves)
        flat = draw(total, generator=gen, device=device)
        at = 0
        for name, shape, _, value in leaves:
            n = _numel(shape)
            x = flat[at:at + n].reshape(shape)
            out[name] = x * value if kind == "normal" else (x * 2.0 - 1.0) * value
            at += n
    for name, shape, kind, value in specs:
        if kind == "const":
            dtype = torch.int64 if isinstance(value, int) and not isinstance(value, bool) \
                and name.endswith("num_batches_tracked") else torch.float32
            out[name] = torch.full(shape, value, dtype=dtype, device=device)
    return {name: out[name] for name, *_ in specs}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
