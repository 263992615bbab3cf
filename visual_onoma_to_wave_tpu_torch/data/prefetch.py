"""Background-thread batch prefetching (copy of visual_onoma_to_wave_tpu/data/prefetch.py).

The reference hides loader latency behind 10 DataLoader worker processes
(reference scripts/04_train.py:50-58). Here host batch assembly (np.load +
PNG decode + native cell fill) overlaps device compute through a small
bounded queue serviced by one producer thread — enough, since PyTorch's
kernels release the GIL while the device runs.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Iterate `it` on a background thread, keeping up to `depth` items
    ready. Exceptions re-raise at the consumer; the thread is a daemon so an
    abandoned iterator cannot hang interpreter exit."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err: list[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - re-raised at consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True,
                         name="vow-batch-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item
