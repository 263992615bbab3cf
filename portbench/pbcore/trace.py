"""The traced run's sources: spans the benchmark puts around calls into the
port (host clock), `record_function` ranges around the acoustic forward and
the vocoder, and `torch.profiler` over the window (CPU ops and the device's
kernels, copies and fills).

`idle_share`'s union and the kernel classes are copied from
`tools/profile_torch.py`; the rest reads the profiler's event list.
"""
from __future__ import annotations

import bisect
import functools
import time

import torch

# the port's custom ops, whose device time the kernel metrics read
OPS = ("votw::attention_core", "votw::mrf_stage_fused", "votw::convnext_block")
RANGES = ("acoustic", "vocoder")


def kernel_class(name: str) -> str:
    n = name.lower()
    if n.startswith(("memcpy", "memset")):            # copies and fills, not kernels
        return n.split()[0] + " " + (n.split()[1] if len(n.split()) > 1 else "")
    if "mha_fwd_kernel" in n:
        return "attention"
    if "convnext_kernel" in n:
        return "convnext"
    if "mrf_" in n:
        return "mrf"
    if any(w in n for w in ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd", "fft")):
        return "conv"
    if "gemm" in n or "gemv" in n:
        return "gemm"
    if any(w in n for w in ("elementwise", "vectorized", "reduce", "copy", "fill", "index",
                            "where", "cat")):
        return "elementwise"
    return "other"


def _no_sync() -> None:
    pass


def union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merged, sorted intervals (the busy time of `idle_share`)."""
    out: list[list[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Tracer:
    """Host spans always; the profiler and the ranges only when `profile`."""

    def __init__(self, profile: bool):
        self.profile = profile
        self.spans: list[tuple[str, float, float]] = []
        self.calls: list[dict] = []      # one per fused call: shapes and host times
        self._prof = None
        self.sync = _no_sync

    def span(self, name: str, fn, ranged: bool = False):
        """`fn` timed on the host clock as span `name`, under a profiler
        range if `ranged`."""
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            if ranged:
                with torch.profiler.record_function(name):
                    out = fn(*a, **kw)
            else:
                out = fn(*a, **kw)
            self.spans.append((name, t0, time.perf_counter()))
            return out
        return wrapped

    def instrument(self, synth, cfg: dict) -> None:
        """Spans around the port's synthesis steps, ranges around the models,
        and one shape record per fused call."""
        t_max = cfg["acoustic"]["max_mel_len"]
        fused = synth._fused
        sync = self.sync = torch.cuda.synchronize if synth.device.type == "cuda" else _no_sync

        def fused_call(batch, e_control=1.0, d_control=1.0):
            sync()
            t0 = time.perf_counter()
            out = fused(batch, e_control=e_control, d_control=d_control)
            sync()
            t1 = time.perf_counter()
            rec = {"B": int(batch["texts"].shape[0]), "C": int(batch["texts"].shape[1]),
                   "src_lens": batch["src_lens"].tolist(), "mel_lens": out["mel_lens"].tolist(),
                   "T": t_max, "fused_s": t1 - t0}
            self.spans.append(("fused", t0, t1))
            self.calls.append(rec)
            return out

        synth._fused = fused_call
        synth._render_cells = self.span("render", synth._render_cells)
        synth._run = self.span("h2d_fused_d2h", synth._run)
        batch_fn = synth.synthesize_batch

        def synthesize_batch(texts, *a, **kw):
            t0 = time.perf_counter()
            out = batch_fn(texts, *a, **kw)
            t1 = time.perf_counter()
            self.spans.append(("synthesize_batch", t0, t1))
            self.calls[-1].update(n=len(texts), batch_s=t1 - t0)   # its one fused call
            return out

        synth.synthesize_batch = synthesize_batch
        synth.model.forward = self.span("acoustic", synth.model.forward, ranged=True)
        synth.vocoder.forward = self.span("vocoder", synth.vocoder.forward, ranged=True)

    # ---------------------------------------------------------- profiler
    def start(self) -> None:
        if not self.profile:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                         else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        with torch.profiler.record_function("pb::mark"):
            self._mark = time.perf_counter()
        self.t_start = time.perf_counter()

    def stop(self) -> dict | None:
        if self._prof is None:
            return None
        self.sync()
        self.t_stop = time.perf_counter()
        self._prof.__exit__(None, None, None)
        summary = self.read(self._prof.events())
        self._prof = None
        return summary

    def read(self, events) -> dict:
        """busy and window seconds, device seconds under each range and op,
        the kernels that took most time, and the idle gaps by host span."""
        from torch.autograd import DeviceType

        def dev_total(e) -> float:
            total = getattr(e, "device_time_total", None)
            return e.cuda_time_total if total is None else total

        device, under, calls, offset = [], {}, {}, None
        by_name: dict[str, float] = {}
        classes: dict[str, float] = {}
        for e in events:
            if e.device_type == DeviceType.CUDA and (getattr(e, "is_user_annotation", False)
                                                     or e.name in RANGES):
                continue                    # a range's span on the device's timeline, no work
            if e.device_type == DeviceType.CUDA:
                s, t = e.time_range.start, e.time_range.end
                device.append((s, t))
                by_name[e.name] = by_name.get(e.name, 0.0) + (t - s) / 1e6
                c = kernel_class(e.name)
                classes[c] = classes.get(c, 0.0) + (t - s) / 1e6
            elif e.name == "pb::mark":
                offset = e.time_range.start - self._mark * 1e6
            elif e.name in OPS or e.name in RANGES:
                parent = e.cpu_parent
                while parent is not None and parent.name != e.name:
                    parent = parent.cpu_parent
                if parent is None:          # the outermost event of its name
                    under[e.name] = under.get(e.name, 0.0) + dev_total(e) / 1e6
                    calls[e.name] = calls.get(e.name, 0) + 1
        if offset is None:                   # no mark: assume the clocks agree at the start
            offset = (min(s for s, _ in device) if device else 0.0) - self.t_start * 1e6
        lo, hi = self.t_start * 1e6 + offset, self.t_stop * 1e6 + offset
        busy = union([(max(s, lo), min(t, hi)) for s, t in device if t > lo and s < hi])
        busy_s = sum(t - s for s, t in busy) / 1e6
        gaps = [(a, b) for a, b in zip([lo] + [t for _, t in busy], [s for s, _ in busy] + [hi])
                if b > a]
        return {"busy_s": busy_s, "window_s": self.t_stop - self.t_start,
                "device_s": under, "op_calls": calls, "classes": classes,
                "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
                "idle_gaps": self.label_gaps(gaps, offset)}

    def label_gaps(self, gaps, offset: float) -> list:
        """Idle time summed by the innermost host span open at each gap's
        middle, the longest first: [["<span>: <n> gaps", seconds], ...]."""
        by: dict[str, list] = {}
        for name, s, e in sorted(self.spans, key=lambda x: x[1]):
            by.setdefault(name, []).append((s * 1e6 + offset, e * 1e6 + offset))
        starts = {name: [s for s, _ in v] for name, v in by.items()}
        total: dict[str, list] = {}
        for a, b in gaps:
            mid = (a + b) / 2
            label, width = "no call", float("inf")
            for name, v in by.items():
                i = bisect.bisect_right(starts[name], mid)
                for s, e in v[max(0, i - 2):i]:     # spans of one name overlap at most in pairs
                    if s <= mid <= e and e - s < width:
                        label, width = name, e - s
            slot = total.setdefault(label, [0, 0.0])
            slot[0] += 1
            slot[1] += (b - a) / 1e6
        ranked = sorted(total.items(), key=lambda kv: -kv[1][1])[:10]
        return [[f"{name}: {n} gaps", s] for name, (n, s) in ranked]
