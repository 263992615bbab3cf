"""The reader of the acoustic model's conv route (`acoustic_conv_kernel_share.offline`):
its arithmetic on hand-made spans, and on the tiny cells on the CPU, where a
traced run reports it equal to the program's counts (every conv through the
modules there) and an untraced run, or a program without the counts,
reports nothing."""
from __future__ import annotations

import sys
from types import SimpleNamespace

import pytest

from conftest import BENCH
from pbcore.spec import load_module
from test_portbench_harness import drive

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
NAME = "acoustic_conv_kernel_share.offline"
TRACING = "visual_onoma_to_wave_tpu_torch.tracing"


def reader():
    return load_module(BENCH / "metrics" / f"{NAME}.py", "pbmetric_acoustic_conv_kernel_share")


def span(name, counts=None):
    return SimpleNamespace(name=name, counts=counts)


@pytest.mark.parametrize("spans,share", [
    ([span("synth.batch", {"synth.rows": 64}),
      span("synth.acoustic", {"synth.acoustic_convs": 25, "synth.acoustic_convs_plain": 0}),
      span("synth.acoustic", {"synth.acoustic_convs": 25, "synth.acoustic_convs_plain": 0})],
     100.0),
    ([span("synth.acoustic", {"synth.acoustic_convs": 0, "synth.acoustic_convs_plain": 25})],
     0.0),
    ([span("synth.acoustic", {"synth.acoustic_convs": 20, "synth.acoustic_convs_plain": 5}),
      span("synth.acoustic", {"synth.acoustic_convs_plain": 25})], 40.0),
    ([span("synth.batch", {"synth.rows": 64}), span("synth.acoustic"),
      span("synth.vocoder", {"synth.amp_sites": 109})], None),
    ([], None)], ids=["all-kernel", "all-plain", "mixed", "no-counts", "empty"])
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
    kernel, plain = (sum(s.counts.get(k, 0) for s in spans if s.counts)
                     for k in ("synth.acoustic_convs", "synth.acoustic_convs_plain"))
    calls = sum(1 for s in spans if s.name == "synth.acoustic")
    assert kernel == 0 and plain > 0 and plain % calls == 0    # the CPU runs the modules
    assert res["metrics"][NAME]["value"] == 0.0
    assert res["metrics"][NAME]["unit"] == "%"
    assert NAME not in drive(tiny_root, workload, trace=0)["metrics"]
