"""Spans and counts on the port's synthesis path, on the profiler's clock.

    from visual_onoma_to_wave_tpu_torch import tracing

    call = tracing.new_call()
    with tracing.span("synth.batch", call=call):
        with tracing.span("synth.render_one", req=(call, 0), ranged=False):
            ...
        tracing.count("synth.rows", 1)

A span records its name, its start and end in `time.perf_counter_ns()`, its
parent (the innermost span open on its thread), the call id of the
`synthesize_batch` it belongs to, the request id where it is one request's,
and the counts made while it was the innermost span. Spans are recorded
only while a `torch.profiler` session is active; each then also opens
`torch.profiler.record_function(name)`, so that it lies on the profiler's
timeline beside the kernels, copies and fills that it caused. Off, a span
costs one boolean check (and one store).

A session's first span starts a fresh buffer: the first span recorded after
the recorder saw the profiler off (a span or a read of `spans()` while no
session is active; between two sessions a program runs untraced calls, or
reads the spans of the first). It also records one anchor range,
`tracing.anchor`, whose profiler time converts the recorder's stamps to the
profiler's time base (`offset_us`). The buffer holds `CAPACITY` spans; past
that, spans are dropped and counted under `tracing.dropped`.

A span opened with `ranged=False` (one request's render, 64 a call) is
recorded with its parent, call and request but opens no profiler range:
under a session with CUDA activity a range costs 0.11-0.14 ms of host time
(an H100 host, torch 2.11), so 64 of them would add ~8 ms to a call.

`count(name, n)` adds to cumulative per-process counters whether a session
is active or not, and attaches `n` to the innermost open span while one is.
Nothing is written out here: the profiler's trace carries the ranges,
`serve.BatchingServer`'s `/v1/stats` the counters, and `breakdown()` sums a
session's spans a call of `synthesize_batch` (`cli synthesize-batch
--profile-dir`).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import statistics
import threading
import time

import torch

CAPACITY = 1 << 16
ANCHOR = "tracing.anchor"

_profiler = torch.autograd.profiler


def profiler_on() -> bool:
    """True while a torch.profiler session records: torch's Python flag,
    set and cleared with the C++ profiler (tests pin the two together)."""
    return _profiler._is_profiler_enabled

_OFF = contextlib.nullcontext()


class Span:
    """One recorded span; `counts` is None when nothing was counted under it."""
    __slots__ = ("name", "start", "end", "id", "parent", "call", "req", "counts", "ranged",
                 "_range")

    def __init__(self, name: str, req=None, call=None, ranged: bool = True):
        self.name, self.req, self.call, self.ranged = name, req, call, ranged
        self.id = self.start = self.end = self.parent = self.counts = self._range = None

    def __enter__(self) -> "Span":
        RECORDER.begin_if_fresh()
        stack = _stack()
        top = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else None
        if self.call is None and top is not None:
            self.call = top.call
        self.start = time.perf_counter_ns()     # the range's own cost counts as this span's
        if self.ranged:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self.end = time.perf_counter_ns()
        RECORDER.keep(self)


class Recorder:
    """The process's span buffer, its session anchor and its counters."""

    def __init__(self):
        self._lock = threading.Lock()
        self.fresh = True          # the next span recorded starts a new buffer
        self.spans: list[Span] = []
        self.anchor_ns: int | None = None
        self.counters: dict[str, int] = {}

    def begin_if_fresh(self) -> None:
        if not self.fresh:
            return
        with self._lock:
            if self.fresh:
                self.spans = []
                with torch.profiler.record_function(ANCHOR):
                    self.anchor_ns = time.perf_counter_ns()
                self.fresh = False

    def keep(self, s: Span) -> None:
        if len(self.spans) < CAPACITY:
            self.spans.append(s)
        else:
            self.add("tracing.dropped", 1)

    def add(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n


RECORDER = Recorder()
_ids = itertools.count()
_calls = itertools.count()
_local = threading.local()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, req=None, call=None, ranged: bool = True):
    """A context manager recording span `name` while a profiler session is
    active. `call` starts a call id (`new_call`) that nested spans inherit;
    `req` is one request's id; `ranged=False` opens no profiler range."""
    if not profiler_on():
        RECORDER.fresh = True
        return _OFF
    return Span(name, req, call, ranged)


def record(name: str, start_ns: int, end_ns: int, req=None) -> None:
    """A span whose ends lie on two threads (a request's wait in a queue),
    given by its `perf_counter_ns` stamps: kept in the buffer (no parent, no
    call) but not opened as a profiler range."""
    if not profiler_on():
        RECORDER.fresh = True
        return
    RECORDER.begin_if_fresh()
    s = Span(name, req, ranged=False)
    s.id, s.start, s.end = next(_ids), start_ns, end_ns
    RECORDER.keep(s)


def count(name: str, n: int) -> None:
    """Add `n` to counter `name`, and to the innermost open span's counts."""
    RECORDER.add(name, int(n))
    stack = getattr(_local, "stack", None)
    if stack:
        top = stack[-1]
        if top.counts is None:
            top.counts = {}
        top.counts[name] = top.counts.get(name, 0) + int(n)


def new_call() -> int:
    """A fresh call id (one per `synthesize_batch`)."""
    return next(_calls)


def spans() -> list[Span]:
    """The spans of the newest session (or of the one still recording).
    Read while the profiler is off, the session is over: the next span
    recorded starts a fresh buffer."""
    if not profiler_on():
        RECORDER.fresh = True
    return list(RECORDER.spans)


def counters() -> dict[str, int]:
    """The cumulative counters since the process started."""
    with RECORDER._lock:
        return dict(RECORDER.counters)


def offset_us(events) -> float | None:
    """Microseconds to add to a stamp / 1e3 to place it on the time base of
    the profiler's `events` (their `time_range`), from the session's anchor
    range; None when `events` hold no anchor."""
    for e in events:
        if e.name == ANCHOR and RECORDER.anchor_ns is not None:
            return e.time_range.start - RECORDER.anchor_ns / 1e3
    return None


def breakdown(recorded: list[Span] | None = None) -> dict:
    """The host's time and counts a call of `Synthesizer.synthesize_batch`,
    from `recorded` spans (default: the newest session's): the mean ms of
    `synth.batch` and of each of its children, its self time (what no child
    covers), each request's render (`synth.render_one`: median, max and the
    slowest request's id) and the counts of the calls' spans; {} when no
    call was recorded."""
    recorded = spans() if recorded is None else recorded
    batches = {s.id: s for s in recorded if s.name == "synth.batch"}
    if not batches:
        return {}
    calls = {s.call for s in batches.values()}
    ms = collections.defaultdict(float)
    counts = collections.Counter()
    renders = []
    for s in recorded:
        if s.call not in calls:
            continue
        d = (s.end - s.start) / 1e6
        if s.parent in batches:
            ms[s.name] += d
        elif s.name == "synth.render_one":
            renders.append((d, s.req))
        counts.update(s.counts or {})
    total = sum(b.end - b.start for b in batches.values()) / 1e6
    n = len(batches)
    out = {"calls": n,
           "ms_per_call": {"synth.batch": total / n, **{k: v / n for k, v in sorted(ms.items())},
                           "self": (total - sum(ms.values())) / n},
           "counts_per_call": {k: v / n for k, v in sorted(counts.items())}}
    if renders:
        slowest = max(renders, key=lambda r: r[0])
        out["render_one_ms"] = {"median": statistics.median(d for d, _ in renders),
                                "max": slowest[0], "slowest": slowest[1]}
    return out
