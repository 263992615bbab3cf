"""The reader of the renderer's cell lookups (`glyph_hit_share.offline`): its
arithmetic on hand-made spans, and on the tiny cells on the CPU, where a
traced run reports it equal to the program's counts and an untraced run or
a program without the counts reports nothing."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from conftest import BENCH
from pbcore.spec import load_module
from test_portbench_harness import drive

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
NAME = "glyph_hit_share.offline"
TRACING = "visual_onoma_to_wave_tpu_torch.tracing"


def reader():
    return load_module(BENCH / "metrics" / f"{NAME}.py", "pbmetric_glyph_hit_share_offline")


def span(name, counts=None):
    return SimpleNamespace(name=name, counts=counts)


@pytest.mark.parametrize("spans,share", [
    ([span("synth.batch", {"synth.rows": 2}),
      span("synth.render_one", {"synth.glyph_hits": 3, "synth.glyph_misses": 1}),
      span("synth.render_one", {"synth.glyph_hits": 4}),
      span("synth.batch"), span("synth.render_one", {"synth.glyph_misses": 2})], 70.0),
    ([span("synth.batch"), span("synth.render_one", {"synth.glyph_hits": 5})], 100.0),
    ([span("synth.batch"), span("synth.render_one", {"synth.glyph_misses": 5})], 0.0),
    ([span("synth.batch", {"synth.rows": 1}), span("synth.render_one")], None),
    ([span("synth.render_one", {"synth.glyph_hits": 5})], None),
    ([], None)], ids=["mixed", "all-hits", "all-misses", "no-counts", "no-call", "empty"])
def test_share_of_hand_made_spans(monkeypatch, spans, share):
    monkeypatch.setitem(sys.modules, TRACING, SimpleNamespace(spans=lambda: spans))
    assert reader().read({}) == share


def test_none_without_the_recorder(monkeypatch):
    monkeypatch.delitem(sys.modules, TRACING, raising=False)
    assert reader().read({}) is None


@pytest.mark.parametrize("workload", ["tiny.hifigan_offline", "tiny.vocos_offline"])
def test_traced_run_reports_the_programs_share(tiny_root, workload):
    from visual_onoma_to_wave_tpu_torch import tracing

    res = drive(tiny_root, workload, trace=1)
    assert res["correct"] is True
    spans = tracing.spans()
    hits, misses = (sum(s.counts.get(k, 0) for s in spans if s.counts)
                    for k in ("synth.glyph_hits", "synth.glyph_misses"))
    chars = sum(s.counts.get("synth.chars", 0) for s in spans if s.counts)
    assert hits + misses == chars > 0
    assert res["metrics"][NAME]["value"] == pytest.approx(100.0 * hits / chars, rel=1e-12)
    assert res["metrics"][NAME]["unit"] == "%"
    assert NAME not in drive(tiny_root, workload, trace=0)["metrics"]
