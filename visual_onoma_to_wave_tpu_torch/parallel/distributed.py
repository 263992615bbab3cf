"""Multi-process data parallelism over `torch.distributed` (port of
visual_onoma_to_wave_tpu/parallel/distributed.py).

Every process runs the same command. `init_distributed` joins the process
group: gloo on the CPU, nccl on the card (one card per process, picked by
`local_device`). Every process then plans the identically seeded epoch (so
all agree on each global batch and its padded shapes) and keeps only its
own rows of each global batch (`shard_batch_multiprocess`); the trainers
sum their gradients over the processes (`all_reduce_grads`) so that a step
of P processes is the one-process step on the global batch
(`training/trainer.py`, `training/vocoder_trainer.py`). Only the primary
process writes checkpoints, logs and samples; `barrier` keeps the others
from leaving while it does.

JAX's `parallel/mesh.py` has no counterpart: a process drives its own card,
and `parallel/serving.py::make_sharded_synth` takes a list of devices.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Any

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device: str = "cuda",
                     timeout_s: float = 600.0) -> None:
    """Join (or start) the process group: gloo when `device` is the CPU,
    nccl on the card. `coordinator_address` is process 0's host:port
    (`tcp://` is added); without it the group reads torchrun's environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE)."""
    if dist.is_initialized():
        return
    backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
    kwargs: dict[str, Any] = {"backend": backend, "timeout": timedelta(seconds=timeout_s)}
    if coordinator_address is not None:
        addr = coordinator_address
        kwargs["init_method"] = addr if "://" in addr else f"tcp://{addr}"
        kwargs["world_size"] = int(num_processes if num_processes is not None
                                   else os.environ["WORLD_SIZE"])
        kwargs["rank"] = int(process_id if process_id is not None else os.environ["RANK"])
    else:
        kwargs["init_method"] = "env://"
    if backend == "nccl":
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(**kwargs)
    if backend == "nccl":
        # form the communicator now, while every process is at this point
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def is_primary() -> bool:
    """True on the process that owns host-side side effects (checkpoint
    writes, metric logs, sample wavs)."""
    return process_index() == 0


def local_device(device: str | torch.device = "cuda") -> torch.device:
    """This process's device: "cuda" without an index becomes the card of
    its local rank (torchrun's LOCAL_RANK, else the rank modulo the cards
    visible); any other device is returned as it is."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else process_index()
    return torch.device("cuda", index % max(torch.cuda.device_count(), 1))


def barrier(name: str | None = None) -> None:
    """Block until every process reaches this point (nothing with one)."""
    if not is_multiprocess():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _rows(x, p: int, n: int):
    b = len(x)
    if b % n:
        raise ValueError(f"batch size {b} not divisible by {n} processes")
    rows = b // n
    return x[p * rows:(p + 1) * rows]


def shard_batch_multiprocess(batch: dict, already_local: bool = False) -> dict:
    """This process's rows of a global batch.

    already_local=False: every process holds the same full batch (identical
    seeds make the loaders agree); each keeps its contiguous row slice
    [p*B/P, (p+1)*B/P) of every array and list (B must divide by P).
    already_local=True: the batch already holds only this process's rows,
    and is returned as it is. None values stay None."""
    if already_local or not is_multiprocess():
        return batch
    p, n = process_index(), process_count()
    return {k: v if v is None or np.ndim(v) == 0 else _rows(v, p, n) for k, v in batch.items()}


def host_tree(tree):
    """Every process's rows of a dict (or list) of arrays or tensors,
    concatenated along the batch axis, on every process, as numpy (one
    process: its own tree). A collective: every process must call it."""
    def gather(x):
        if x is None:
            return None
        x = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        if not is_multiprocess():
            return x
        parts = [None] * process_count()
        dist.all_gather_object(parts, x)
        return np.concatenate(parts, axis=0)

    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    return [gather(v) for v in tree]


def all_reduce_tensors(tensors: list[torch.Tensor], average: bool = False) -> None:
    """Sum (or average) `tensors` over the processes in place, as one flat
    buffer per dtype (nothing without a process group)."""
    if not (dist.is_available() and dist.is_initialized()) or not tensors:
        return
    n = process_count()
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        if average:
            flat /= n
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


class _AllReduceSum(torch.autograd.Function):
    """The sum over the processes, whose gradient is the sum of the
    processes' gradients (every process's loss reads the same sum)."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the processes, differentiably."""
    return _AllReduceSum.apply(x)


def all_reduce_grads(params, average: bool = False) -> None:
    """Sum (or average) the `.grad` of `params` over the processes; a
    parameter without a gradient gets a zero one first, so that every
    process reduces the same buffers."""
    if not (dist.is_available() and dist.is_initialized()):
        return
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_tensors([p.grad for p in params], average)


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` from process `src`."""
    if not is_multiprocess():
        return
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src)
