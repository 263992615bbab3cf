"""The harness end to end on the CPU at a tiny size: a sound run is
correct, and a run whose timed path is broken underneath is not. The
harness's look for a card is skipped (`run.main(device="cpu")`); the rest
of a run is the one the benchmark makes on the card. Also: a cell,
configuration, mix, driver, model family and metric added as files only
are found by name, an unknown driver is refused, and a run without a card
exits without a result."""
from __future__ import annotations

import contextlib
import io
import json
import shutil

import pytest
import torch

import run
from conftest import BENCH, make_checkout
from pbcore import program

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")
SEED = 3_000_000_123        # larger than 32 signed bits hold


def drive(root, workload: str, trace: int = 0, seconds: float = 2.0, out=None) -> dict:
    """The result line of one run on the CPU; the whole output goes to `out`."""
    out = out if out is not None else io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(SEED), "--seconds", str(seconds),
                       "--trace", str(trace)], device="cpu", root=root)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("workload,trace", [("tiny.hifigan_offline", 0),
                                            ("tiny.vocos_offline", 1),
                                            ("tiny.vocos_offline", 0),
                                            ("tiny.hifigan_offline", 1)])
def test_sound_run_is_correct(tiny_root, workload, trace):
    res = drive(tiny_root, workload, trace)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    names = set(res["metrics"])
    if trace:
        assert "breakdown" in res and {"busy_s", "window_s"} <= set(res["device"])
        assert names and all(n.endswith(".offline") for n in names)
    else:
        assert "setup_s" in names and len(names) >= 2


def broken(monkeypatch, fault):
    """The port's fused call broken underneath by `fault(out)`."""
    build = program.build

    def build_broken(*a, **kw):
        synth = build(*a, **kw)
        fused = synth._fused

        def call(batch, **kwargs):
            out = fused(batch, **kwargs)
            fault(out)
            return out

        synth._fused = call
        return synth

    monkeypatch.setattr(program, "build", build_broken)


def answer_altered(out):
    out["wav"] = out["wav"] * 1.05


def duration_altered(out):
    out["duration_rounded"] = out["duration_rounded"].clone()
    out["duration_rounded"][:, 0] += 1


def half_left_out(out):
    b = out["wav"].shape[0]
    for key in ("wav", "postnet_mel"):
        out[key] = out[key].clone()
        out[key][b // 2:] = 0.0


@pytest.mark.parametrize("fault", [answer_altered, duration_altered, half_left_out])
@pytest.mark.parametrize("workload", ["tiny.hifigan_offline", "tiny.vocos_offline"])
def test_broken_run_is_not_correct(tmp_path, monkeypatch, workload, fault):
    root = make_checkout(tmp_path)
    if fault is half_left_out:   # sample every answer, so that the dropped rows are among them
        mix = root / BENCH.name / "traffic" / "tiny_offline.json"
        m = json.loads(mix.read_text())
        m["sample"] = 64
        mix.write_text(json.dumps(m))
    broken(monkeypatch, fault)
    res = drive(root, workload)
    assert res["correct"] is False


def test_control_fails_the_limits(tiny_root):
    """The reference one precision below the configuration's, in the
    program's place (`control.py`), fails one of the numbers."""
    import control

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert control.main(["--workload", "tiny.hifigan_offline", "--seeds", "1", "2",
                             "--program"], device="cpu", root=tiny_root) == 0
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    limits = json.loads((BENCH / "tests" / "tiny_hifigan.json").read_text())["limits"]
    for row in rows:
        over = [k for k in limits if k in row and row[k] > limits[k]]
        assert bool(over) == (row["side"] == "control"), row


PAIRS_DRIVER = """
import pathlib

from pbcore import spec

_offline = spec.load_module(pathlib.Path(__file__).with_name("offline.py"), "pbdriver_offline")
warm_up, control_requests, answer = _offline.warm_up, _offline.control_requests, _offline.answer


def run(synth, mix, cfg, seed, seconds):
    out = _offline.run(synth, mix, cfg, seed, seconds)
    out["end_to_end"]["requests_per_s"] = out["attempted"] / seconds
    out["lines"].append("driver: pairs")
    return out
"""


def test_parts_added_as_files_are_found(tmp_path):
    """A configuration, a model family, a mix, a driver, an end-to-end and a
    per-layer metric and a cell that only add files and entries run without
    an edit to any file the benchmark has. The family is HiFi-GAN's
    reference under another name, served by the port's HiFi-GAN."""
    root = make_checkout(tmp_path)
    bdir = root / BENCH.name
    before = {p.relative_to(bdir): p.read_bytes() for p in bdir.rglob("*") if p.is_file()}
    (bdir / "reference" / "hifigan_b.py").write_bytes(
        (bdir / "reference" / "hifigan.py").read_bytes())
    cfg = json.loads((bdir / "configs" / "tiny_hifigan.json").read_text())
    cfg["name"] = "tiny_hifigan_b"
    cfg["vocoder"]["family"] = "hifigan_b"
    (bdir / "configs" / "tiny_hifigan_b.json").write_text(json.dumps(cfg))
    (bdir / "drivers" / "pairs.py").write_text(PAIRS_DRIVER)
    mix = json.loads((bdir / "traffic" / "tiny_offline.json").read_text())
    mix.update(driver="pairs", batch=2, chars=[3, 3])
    (bdir / "traffic" / "tiny_pairs.json").write_text(json.dumps(mix))
    (bdir / "metrics" / "calls_per_s.pairs.py").write_text(
        'NAME = "calls_per_s.pairs"\nUNIT = "1/s"\nLAYER = "host synthesis (synthesis.py '
        'Synthesizer)"\nSOURCE = "program_span"\nMOVES = "requests_per_s"\n\n\n'
        'def read(ctx):\n    tr = ctx.get("trace")\n'
        '    return len(ctx["calls"]) / tr["window_s"] if tr else None\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_hifigan_b", "source": "https://arxiv.org/abs/2010.05646",
                             "file": f"{BENCH.name}/configs/tiny_hifigan_b.json", "reduced": [],
                             "why": "CPU-sized"})
    bench["workloads"].append({"name": "tiny.pairs", "config": "tiny_hifigan_b",
                               "traffic": "tiny_pairs", "chips": 1, "why": "CPU-sized"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "tiny.hifigan_offline" in m["workloads"]:
            m["workloads"].append("tiny.pairs")
    bench["end_to_end"].append({"name": "requests_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.25, "source": "host_clock", "workloads": ["tiny.pairs"]})
    bench["per_layer"].append({"name": "calls_per_s.pairs", "unit": "1/s", "better": "higher",
                               "source": "program_span",
                               "layer": "host synthesis (synthesis.py Synthesizer)",
                               "moves": "requests_per_s", "workloads": ["tiny.pairs"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = io.StringIO()
    res = drive(root, "tiny.pairs", out=out)
    assert res["correct"] is True, res["checks"]
    assert {"requests_per_s", "audio_x_realtime", "setup_s"} <= set(res["metrics"])
    assert "driver: pairs" in out.getvalue()
    res = drive(root, "tiny.pairs", trace=1)
    assert res["correct"] is True
    assert res["metrics"]["calls_per_s.pairs"]["value"] > 0
    # the new family's FLOP counter is the one the MFU reads
    assert res["metrics"]["mfu.offline"]["value"] > 0
    after = {p.relative_to(bdir): p.read_bytes() for p in bdir.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)


def test_unknown_driver_is_refused(tmp_path):
    """A mix whose driver has no file under drivers/ stops the run before
    anything is built, naming the drivers there."""
    root = make_checkout(tmp_path)
    mix = root / BENCH.name / "traffic" / "tiny_offline.json"
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()), driver="training")))
    with pytest.raises(SystemExit, match="no driver 'training'.*offline"):
        run.main(["--workload", "tiny.hifigan_offline", "--seed", "1", "--seconds", "1"],
                 device="cpu", root=root)


def test_no_card_no_result(tiny_root, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    rc = run.main(["--workload", "hifigan_v1.batch64_full", "--seed", "1", "--seconds", "1"],
                  root=tiny_root)
    assert rc != 0 and capsys.readouterr().out == ""


def test_bench_only_directory_fails(tmp_path, capsys):
    """A directory with only BENCHMARK.json and the benchmark's files cannot
    run the program: no result."""
    shutil.copytree(BENCH, tmp_path / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, str(tmp_path / BENCH.name / "run.py"), "--workload",
                           "hifigan_v1.batch64_full", "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
