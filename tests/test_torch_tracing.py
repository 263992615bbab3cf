"""The port's span recorder (`visual_onoma_to_wave_tpu_torch/tracing.py`)
and the spans and counts of `Synthesizer.synthesize_batch` on the CPU.

Off (no `torch.profiler` session), nothing is recorded and no profiler
range is opened; under a session each span is recorded with its parent,
call id and counts, appears in the profiler's events under its name, and
converts to the profiler's time base through the session's anchor. The
Synthesizer is the tiny one of tests/test_torch_serve.py.
"""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from test_torch_serve import port_synthesizer
from test_trainer_synthesis import tiny_env  # noqa: F401 (fixture reuse)
from visual_onoma_to_wave_tpu_torch import tracing


def session():
    return profile(activities=[ProfilerActivity.CPU])


def test_profiler_flag_is_the_one_this_torch_has():
    """The recorder reads torch.autograd.profiler's Python flag (torch 2.11
    has it); it agrees with the C++ flag in and out of a session."""
    assert hasattr(torch.autograd.profiler, "_is_profiler_enabled")
    assert tracing.profiler_on() is False
    assert torch._C._autograd._profiler_enabled() is False
    with session():
        assert tracing.profiler_on() is True
        assert torch._C._autograd._profiler_enabled() is True
    assert tracing.profiler_on() is False


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def spy(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    before = tracing.spans()
    counted = tracing.counters().get("test.off", 0)
    with tracing.span("test.outer", call=tracing.new_call()):
        with tracing.span("test.inner", req=(0, 0)):
            tracing.count("test.off", 3)
    tracing.record("test.crossed", 0, 1, req=7)
    assert opened == []
    assert [s.id for s in tracing.spans()] == [s.id for s in before]
    # the cumulative counters are always on
    assert tracing.counters()["test.off"] == counted + 3


def test_spans_carry_parent_call_request_and_counts_and_reach_the_profiler():
    call = tracing.new_call()
    with session() as prof:
        with tracing.span("test.batch", call=call):
            tracing.count("test.rows", 2)
            for row in range(2):
                with tracing.span("test.one", req=(call, row)):
                    tracing.count("test.bytes", 10 + row)
        with tracing.span("test.after"):
            pass
    spans = {(s.name, s.req): s for s in tracing.spans()}
    batch = spans[("test.batch", None)]
    assert batch.parent is None and batch.call == call and batch.counts == {"test.rows": 2}
    for row in range(2):
        one = spans[("test.one", (call, row))]
        assert one.parent == batch.id and one.call == call
        assert one.counts == {"test.bytes": 10 + row}
        assert batch.start <= one.start <= one.end <= batch.end
    after = spans[("test.after", None)]
    assert after.parent is None and after.call is None and after.counts is None
    names = [e.name for e in prof.events()]
    assert names.count("test.batch") == 1 and names.count("test.one") == 2
    assert names.count("test.after") == 1 and names.count(tracing.ANCHOR) == 1


def test_anchor_converts_stamps_to_the_profiler_clock_within_1ms():
    with session() as prof:
        for i in range(5):
            with tracing.span(f"test.clock{i}"):
                sum(range(20000 * (i + 1)))
    events = prof.events()
    offset = tracing.offset_us(events)
    assert offset is not None
    by_name = {e.name: e for e in events}
    for s in tracing.spans():
        e = by_name[s.name]
        assert abs(s.start / 1e3 + offset - e.time_range.start) < 1000.0
        assert abs(s.end / 1e3 + offset - e.time_range.end) < 1000.0


def test_a_new_session_clears_the_buffer_and_a_full_one_counts_drops(monkeypatch):
    with session():
        with tracing.span("test.first"):
            pass
    assert [s.name for s in tracing.spans()] == ["test.first"]
    with tracing.span("test.untraced"):     # the program's calls between two sessions
        pass
    with session():
        with tracing.span("test.second"):
            pass
    assert [s.name for s in tracing.spans()] == ["test.second"]

    monkeypatch.setattr(tracing, "CAPACITY", 3)
    dropped = tracing.counters().get("tracing.dropped", 0)
    with tracing.span("test.untraced"):
        pass
    with session():
        for i in range(5):
            with tracing.span(f"test.full{i}"):
                pass
    assert [s.name for s in tracing.spans()] == ["test.full0", "test.full1", "test.full2"]
    assert tracing.counters()["tracing.dropped"] == dropped + 2


def test_an_unranged_span_is_recorded_but_opens_no_range():
    call = tracing.new_call()
    with session() as prof:
        with tracing.span("test.outer", call=call):
            with tracing.span("test.quiet", req=(call, 0), ranged=False):
                tracing.count("test.quiet_bytes", 5)
    spans = {s.name: s for s in tracing.spans()}
    quiet = spans["test.quiet"]
    assert quiet.parent == spans["test.outer"].id and quiet.call == call
    assert quiet.req == (call, 0) and quiet.counts == {"test.quiet_bytes": 5}
    names = [e.name for e in prof.events()]
    assert "test.outer" in names and "test.quiet" not in names


def test_threads_keep_separate_stacks():
    """Two threads, as the server's two calls in flight, nest their spans
    in step: each inner span's parent is its own thread's outer span."""
    step = threading.Barrier(2, timeout=30)

    def worker(k: int) -> None:
        with tracing.span("test.outer", req=k, call=tracing.new_call()):
            step.wait()
            with tracing.span("test.inner", req=k):
                step.wait()
            step.wait()

    with session():
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    spans = {(s.name, s.req): s for s in tracing.spans()}
    for k in range(2):
        outer, inner = spans[("test.outer", k)], spans[("test.inner", k)]
        assert outer.parent is None and inner.parent == outer.id
        assert inner.call == outer.call
    assert spans[("test.outer", 0)].call != spans[("test.outer", 1)].call


@pytest.fixture(scope="module")
def synth(tiny_env):  # noqa: F811
    return port_synthesizer(tiny_env)


def test_synthesizer_spans_and_counts_equal_the_arrays(synth):
    """One call of three requests: h2d_bytes, d2h_bytes, frames and
    frames_vocoded equal the sums of the copied arrays' nbytes and the
    requests' lengths; the request ids of synth.render_one are the rows; every
    span of the call carries its call id."""
    seen = {}
    run = synth._run

    def spy(batch, e_ctl, d_ctl):
        seen["h2d"] = sum(v.nbytes for v in batch.values()) + e_ctl.nbytes + d_ctl.nbytes
        out = run(batch, e_ctl, d_ctl)
        seen["out"] = out
        return out

    synth._run = spy
    counted = tracing.counters()
    try:
        with session() as prof:
            results = synth.synthesize_batch(["パン", "ドンドン", "カ"], ["drum"] * 3,
                                             e_control=[1.0, 1.2, 0.9])
    finally:
        del synth._run
    out = seen["out"]
    spans = tracing.spans()
    batch = [s for s in spans if s.name == "synth.batch"]
    assert len(batch) == 1
    call = batch[0].call

    def total(name):
        return sum(s.counts.get(name, 0) for s in spans if s.counts)

    d2h = sum(v.nbytes for v in out.values() if isinstance(v, np.ndarray))
    expected = {"synth.h2d_bytes": seen["h2d"], "synth.d2h_bytes": d2h,
                "synth.frames": sum(r.mel_len for r in results),
                "synth.frames_vocoded": out["postnet_mel"].shape[0] * out["postnet_mel"].shape[1],
                "synth.rows": 3, "synth.rows_padded": 4, "synth.chars": 7,
                "synth.chars_padded": 4 * 4}
    for name, n in expected.items():
        assert total(name) == n, name
        assert tracing.counters()[name] - counted.get(name, 0) == n, name
    assert total("synth.frames") < total("synth.frames_vocoded")
    assert [s.req for s in spans if s.name == "synth.render_one"] == [(call, i) for i in range(3)]
    assert all(s.call == call for s in spans if s.name.startswith("synth."))
    children = {s.name for s in spans if s.parent == batch[0].id}
    assert children == {"synth.render", "synth.pad", "synth.h2d", "synth.lock_wait",
                        "synth.fused", "synth.d2h", "synth.slice"}
    fused = next(s for s in spans if s.name == "synth.fused")
    assert {s.name for s in spans if s.parent == fused.id} == {"synth.acoustic", "synth.vocoder"}
    names = {e.name for e in prof.events()}
    assert {s.name for s in spans if s.ranged} <= names
    assert "synth.render_one" not in names      # 64 a call: recorded, but no profiler range


def test_breakdown_sums_each_call_by_its_spans(synth):
    """`tracing.breakdown` over two calls: the mean ms of `synth.batch` is
    its children's plus its self time, the counts a call are the calls'
    counts over two, and the slowest render is one of the requests."""
    texts = [["パン", "ドンドン", "カ"], ["パパ", "ド", "カカカ"]]
    with session():
        for t in texts:
            synth.synthesize_batch(t, ["drum"] * 3)
    spans = tracing.spans()
    host = tracing.breakdown(spans)
    assert host["calls"] == 2
    ms = host["ms_per_call"]
    assert set(ms) == {"synth.batch", "synth.render", "synth.pad", "synth.h2d",
                       "synth.lock_wait", "synth.fused", "synth.d2h", "synth.slice", "self"}
    parts = sum(v for k, v in ms.items() if k != "synth.batch")
    assert ms["self"] >= 0 and parts == pytest.approx(ms["synth.batch"], rel=1e-9)
    counts = host["counts_per_call"]
    assert counts["synth.rows"] == 3 and counts["synth.rows_padded"] == 4
    assert counts["synth.chars"] == (7 + 6) / 2
    for name in ("synth.h2d_bytes", "synth.d2h_bytes", "synth.frames", "synth.frames_vocoded"):
        assert counts[name] == sum(s.counts.get(name, 0) for s in spans if s.counts) / 2
    calls = {s.call for s in spans if s.name == "synth.batch"}
    call, row = host["render_one_ms"]["slowest"]
    assert call in calls and 0 <= row < 3
    assert 0 < host["render_one_ms"]["median"] <= host["render_one_ms"]["max"]
    assert tracing.breakdown([s for s in spans if s.name != "synth.batch"]) == {}


def test_cli_synthesize_batch_profile_dir_prints_the_host_breakdown(tmp_path, capsys):
    """`cli synthesize-batch --profile-dir` on the demo checkpoint (CPU):
    the profiler's trace holds the program's ranges, and the printed
    breakdown the host time and counts a call of its two batches."""
    import json
    import pathlib

    from visual_onoma_to_wave_tpu_torch.cli import main

    demo = pathlib.Path(__file__).resolve().parents[1] / "examples" / "checkpoints" / "demo"
    rows = tmp_path / "rows.txt"
    rows.write_text("パン\tdrum\nドンドン\tbell\nカ\tdrum\n", encoding="utf-8")
    prof_dir = tmp_path / "prof"
    assert main(["synthesize-batch", str(demo / "config.json"), str(rows), str(tmp_path / "out"),
                 "--acoustic", str(demo / "torch" / "acoustic.npz"),
                 "--vocoder", str(demo / "torch" / "vocoder.npz"), "--batch-size", "2",
                 "--device", "cpu", "--profile-dir", str(prof_dir)]) == 0
    assert len(list((tmp_path / "out").iterdir())) == 3
    line = next(ln for ln in capsys.readouterr().out.splitlines() if "host_breakdown" in ln)
    host = json.loads(line)["host_breakdown"]
    assert host["calls"] == 2 and host["counts_per_call"]["synth.rows"] == 1.5
    assert {"synth.render", "synth.fused", "synth.d2h", "self"} <= set(host["ms_per_call"])
    assert sorted(p.name for p in prof_dir.iterdir()) == ["trace.json"]
    names = {e["name"] for e in json.loads((prof_dir / "trace.json").read_text())["traceEvents"]}
    assert {"synth.batch", "synth.render", "synth.fused", "synth.acoustic"} <= names


def test_sharded_call_counts_its_copies_per_replica(synth):
    """Over two devices (two CPU replicas) the same call counts the same
    rows, frames, vocoded frames and H2D bytes as on one, its copies spanned
    per replica inside `synth.fused`, and the D2H bytes of the outputs that
    a served batch reads (`parallel.serving.SERVED_OUTPUTS`)."""
    from visual_onoma_to_wave_tpu_torch.parallel.serving import SERVED_OUTPUTS
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    two = Synthesizer(synth.config, synth.model, synth.metadata, synth.symbol_map, synth.vocoder,
                      device="cpu", devices=["cpu", "cpu"])
    texts, types = ["パン", "ドンドン", "カ"], ["drum"] * 3
    totals, seen = [], {}
    run = synth._run

    def spy(*a):
        seen["out"] = run(*a)
        return seen["out"]

    synth._run = spy
    for s in (synth, two):
        try:
            with session():
                s.synthesize_batch(texts, types)
        finally:
            synth.__dict__.pop("_run", None)
        spans = tracing.spans()
        totals.append({k: sum(x.counts.get(k, 0) for x in spans if x.counts)
                       for k in ("synth.rows", "synth.frames", "synth.frames_vocoded",
                                 "synth.h2d_bytes", "synth.d2h_bytes")})
    one, sharded = totals
    d2h = sum(seen["out"][k].nbytes for k in SERVED_OUTPUTS if seen["out"].get(k) is not None)
    assert sharded == dict(one, **{"synth.d2h_bytes": d2h})
    fused = next(x for x in spans if x.name == "synth.fused")
    assert [x.name for x in spans if x.parent == fused.id].count("synth.h2d") == 2
    assert [x.name for x in spans if x.parent == fused.id].count("synth.d2h") == 2
