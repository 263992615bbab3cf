"""Process-parallel training batch loader (copy of visual_onoma_to_wave_tpu/data/loader.py).

The reference hides loader latency behind `DataLoader(num_workers=10)`
worker processes (reference scripts/04_train.py:50-58). Our analog: the
epoch's batch composition is planned up front from metadata only
(`OnomaDataset.batch_plan` — no feature files touched), then each batch's
loading + collation (np.load, PNG decode, native cell fill, padding) fans
out over spawn worker PROCESSES, each holding its own `OnomaDataset`.
Batches stream back IN ORDER with a bounded number in flight, so training
sees exactly the serial `batches()` stream while N cores assemble batches
ahead of the device.

Workers import only the port's dataset layer (numpy + PIL, no torch), so
spawn startup is cheap and the device stays with the training process.

On small hosts/corpora the pool costs more than it buys — `epoch()` falls
back to the serial iterator behind the same thread prefetch the trainer
always used (data/prefetch.py). The decision is explicit in
`ProcessLoader.backend`.
"""
from __future__ import annotations

import os
from typing import Iterator

from visual_onoma_to_wave_tpu_torch.data.dataset import OnomaDataset
from visual_onoma_to_wave_tpu_torch.data.prefetch import prefetch

# module-global per-worker dataset (spawn initializer target)
_DS: OnomaDataset | None = None


def _worker_init(filename, config, sort, drop_last):
    global _DS
    _DS = OnomaDataset(filename, config, sort=sort, drop_last=drop_last)


def _worker_load(idx_list, pad_to=None):
    return _DS.load_batch(idx_list, pad_to=pad_to)


def _worker_probe() -> bool:
    return _DS is not None


def _cpu_count() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


class ProcessLoader:
    """Ordered, bounded-in-flight process-parallel epoch iterator.

    num_workers=None -> min(10, cpus) (the reference's num_workers=10,
    capped by the host); <=1 or cpus<4 or a tiny dataset -> serial+thread
    prefetch (pool startup would dominate — measured in docs/PERF.md).
    """

    MIN_BATCHES_FOR_PROCS = 8

    def __init__(self, dataset: OnomaDataset, filename: str,
                 num_workers: int | None = None, depth: int = 4):
        self.ds = dataset
        self.filename = filename
        cpus = _cpu_count()
        self.num_workers = (min(10, cpus) if num_workers is None
                            else max(1, num_workers))
        self.depth = max(2, depth)
        self._pool = None
        self.backend = "serial"
        # the cpus >= 4 gate applies only to the auto default — an EXPLICIT
        # num_workers request always gets the pool (the user may know their
        # IO profile better than the core count suggests)
        want_pool = (self.num_workers > 1
                     if num_workers is not None
                     else self.num_workers > 1 and cpus >= 4)
        if want_pool:
            self._pool = self._try_start_pool()
            if self._pool is not None:
                self.backend = "process"

    def _try_start_pool(self):
        pool = None
        try:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init,
                initargs=(self.filename, self.ds.config, self.ds.sort,
                          self.ds.drop_last))
            # eager probe: surface spawn/pickling failures here, not mid-epoch
            if not pool.submit(_worker_probe).result(timeout=120):
                raise RuntimeError("worker dataset init failed")
            return pool
        except Exception:
            if pool is not None:
                # never leak spawned workers on a failed probe — the atexit
                # join of a wedged worker would hang interpreter shutdown
                pool.shutdown(wait=False, cancel_futures=True)
            return None

    def epoch(self, group_size: int = 4, seed: int | None = None,
              shuffle: bool = True,
              local_slice: tuple[int, int] | None = None) -> Iterator[dict]:
        """Iterate one epoch of batches, in `OnomaDataset.batch_plan` order.

        local_slice=(p, n): partitioned loading. The epoch is planned
        globally (the same on every process from the shared seed), but this
        process loads and collates only rows [p*B/n, (p+1)*B/n) of each
        batch, padded to the plan's metadata-derived shapes
        (`OnomaDataset.plan_pad_shapes`), so that every process's rows agree
        with the global batch's layout. Feed the result to
        `parallel.shard_batch_multiprocess(..., already_local=True)`."""
        plan = self.ds.batch_plan(group_size, seed, shuffle)
        shapes: list = [None] * len(plan)
        if local_slice is not None:
            p, n = local_slice
            shapes = self.ds.plan_pad_shapes(plan)
            sliced = []
            for chunk in plan:
                if len(chunk) % n:
                    raise ValueError(f"planned batch of {len(chunk)} rows not divisible "
                                     f"by {n} processes")
                rows = len(chunk) // n
                sliced.append(chunk[p * rows:(p + 1) * rows])
            plan = sliced
        if self._pool is None or len(plan) < self.MIN_BATCHES_FOR_PROCS:
            yield from prefetch(self.ds.load_batch(chunk, pad_to=pad)
                                for chunk, pad in zip(plan, shapes))
            return
        yield from self._epoch_pooled(plan, shapes)

    def _epoch_pooled(self, plan, shapes) -> Iterator[dict]:
        from collections import deque

        inflight: deque = deque()
        try:
            for chunk, pad in zip(plan, shapes):
                inflight.append(self._pool.submit(_worker_load, chunk, pad))
                if len(inflight) >= self.depth:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()
        except Exception:
            # a worker died or a batch failed: don't leave futures running
            for f in inflight:
                f.cancel()
            raise

    def close(self) -> None:
        """Cancel the batches not started and wait for the workers to exit
        (a worker still starting would otherwise outlive its corpus)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
            self.backend = "serial"

    def __enter__(self) -> "ProcessLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
