"""The readers of the program's spans and counts (`render_ms_per_call`,
`d2h_ms_per_call`, `d2h_mb_per_call`, `useful_frame_share`) on the tiny
cells, on the CPU: a traced run reports them, the counts equal what the
run's own answers give, an untraced run reports none of them, and the
program's profiler ranges are neither device work nor an op's time to the
trace reader (`pbcore/trace.py::Tracer.read`)."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pbcore import program, trace
from test_portbench_harness import drive

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
NEW = ("render_ms_per_call.offline", "d2h_ms_per_call.offline", "d2h_mb_per_call.offline",
       "useful_frame_share.offline")


def watched(monkeypatch) -> list[dict]:
    """Every traced call's copied outputs and answers, as the program
    returned them."""
    calls = []
    build = program.build

    def build_watched(*a, **kw):
        synth = build(*a, **kw)
        run, batch_fn = synth._run, synth.synthesize_batch

        def run_watched(*ra):
            out = run(*ra)
            if torch.autograd.profiler._is_profiler_enabled:
                calls.append({"out": out})
            return out

        def batch_watched(*ba, **bkw):
            results = batch_fn(*ba, **bkw)
            if torch.autograd.profiler._is_profiler_enabled:
                calls[-1]["mel_lens"] = [r.mel_len for r in results]
            return results

        synth._run, synth.synthesize_batch = run_watched, batch_watched
        return synth

    monkeypatch.setattr(program, "build", build_watched)
    return calls


@pytest.mark.parametrize("workload", ["tiny.hifigan_offline", "tiny.vocos_offline"])
def test_traced_run_reports_the_program_counts(tiny_root, monkeypatch, workload):
    calls = watched(monkeypatch)
    res = drive(tiny_root, workload, trace=1)
    assert res["correct"] is True
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(NEW) <= set(m)
    assert calls and all("mel_lens" in c for c in calls)
    d2h = sum(v.nbytes for c in calls for v in c["out"].values() if isinstance(v, np.ndarray))
    assert m["d2h_mb_per_call.offline"] == pytest.approx(d2h / len(calls) / 1e6, rel=1e-12)
    own = sum(sum(c["mel_lens"]) for c in calls)
    vocoded = sum(int(np.prod(c["out"]["postnet_mel"].shape[:2])) for c in calls)
    assert m["useful_frame_share.offline"] == pytest.approx(100.0 * own / vocoded, rel=1e-12)
    assert 0 < m["useful_frame_share.offline"] < 100
    assert 0 < m["d2h_ms_per_call.offline"] and 0 < m["render_ms_per_call.offline"]
    # the program's host spans lie inside the benchmark's host time a call
    assert m["render_ms_per_call.offline"] < m["host_ms_per_call.offline"]
    assert not [n for n, _ in res["breakdown"]["device_ops"]
                if n.startswith(("synth.", "serve.", "tracing."))]


def test_untraced_run_reports_none_of_them(tiny_root):
    res = drive(tiny_root, "tiny.hifigan_offline", trace=0)
    assert not set(NEW) & set(res["metrics"])


def _event(name, device, start, end, annotation=False, parent=None, device_us=0.0):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end), cpu_parent=parent,
                           device_time_total=device_us)


def test_program_ranges_are_not_device_work():
    """A card's trace as the profiler gives it: the program's ranges on the
    host and, as user annotations, on the device's timeline, around one
    kernel inside the benchmark's `acoustic` range. The reader counts the
    kernel alone as device work and as the range's time."""
    tracer = trace.Tracer(profile=True)
    tracer._mark, tracer.t_start, tracer.t_stop = 0.0, 0.0, 1e-3
    fused = _event("synth.fused", False, 50, 900)
    acoustic = _event("acoustic", False, 100, 800, parent=_event("synth.acoustic", False, 90,
                                                                 850, parent=fused),
                      device_us=200.0)
    events = [_event("pb::mark", False, 0, 1), fused, acoustic,
              _event("synth.fused", True, 300, 700, annotation=True),
              _event("synth.acoustic", True, 300, 600, annotation=True),
              _event("serve.encode", True, 650, 950, annotation=True),
              _event("mrf_kernel", True, 400, 600)]
    summary = tracer.read(events)
    assert summary["busy_s"] == pytest.approx(200e-6)
    assert [n for n, _ in summary["device_ops"]] == ["mrf_kernel"]
    assert summary["device_s"] == {"acoustic": pytest.approx(200e-6)}
    assert summary["op_calls"] == {"acoustic": 1}
