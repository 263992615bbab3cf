"""Fixtures of the benchmark's tests: a checkout in a temporary directory
holding the benchmark and CPU-sized cells (`tiny_*.json`) beside the real
ones, so that the harness runs end to end on the CPU.

    python -m pytest portbench/tests -q
"""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
REPO = BENCH.parent
for p in (str(REPO), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MIXES = {
    "tiny_offline": {"driver": "offline", "batch": 3, "chars": [2, 4], "clip_frames": [20, 40],
                     "clip_dist": "uniform", "width_rate": [0.5, 2.0], "e_control": 1.0,
                     "sample": 2},
}
TINY_CELLS = {"tiny.hifigan_offline": ("tiny_hifigan", "tiny_offline"),
              "tiny.vocos_offline": ("tiny_vocos", "tiny_offline")}


def make_checkout(dest: pathlib.Path) -> pathlib.Path:
    """A copy of the benchmark with the tiny configurations, mixes and cells
    added as files and entries only."""
    shutil.copytree(BENCH, dest / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in ("tiny_hifigan", "tiny_vocos"):
        shutil.copy(BENCH / "tests" / f"{name}.json", dest / BENCH.name / "configs" / f"{name}.json")
        bench["configs"].append({"name": name, "source": "https://arxiv.org/abs/2210.09173",
                                 "file": f"{BENCH.name}/configs/{name}.json", "reduced": [],
                                 "why": "CPU-sized"})
    for name, mix in TINY_MIXES.items():
        (dest / BENCH.name / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, (config, mix) in TINY_CELLS.items():
        bench["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1,
                                   "why": "CPU-sized"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and any(w.endswith("batch64_full") for w in m["workloads"]):
            m["workloads"] += ["tiny.hifigan_offline", "tiny.vocos_offline"]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> pathlib.Path:
    return make_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def cuda():
    """Skips a test marked `gpu` on a host without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
