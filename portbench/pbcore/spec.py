"""Finding a cell's parts by name: `BENCHMARK.json` names the cell's
configuration and traffic mix; the configuration's file is the one its
entry names, the mix is `traffic/<mix>.json`, the mix's driver is
`drivers/<driver>.py`, each per-layer metric is `metrics/<metric>.py`, and
each model family (its plain reference, weights and FLOP count) is
`reference/<family>.py`. A new cell, configuration, mix, driver, metric or
family is a new file and a new entry; no file here changes.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]      # the benchmark's folder
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "visual_onoma_to_wave_tpu")
PORT = "visual_onoma_to_wave_tpu_torch"


def load_module(path: pathlib.Path, name: str):
    """The Python file at `path` as module `name` (loaded once)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


class Cell:
    """One `workloads` entry with its configuration, mix, metrics and
    reference families, read from the checkout `root`."""

    def __init__(self, name: str, root: pathlib.Path):
        self.root = pathlib.Path(root)
        self.bench_dir = self.root / BENCH.name
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
        self.workload = cells[name]
        entry = {c["name"]: c for c in self.bench["configs"]}[self.workload["config"]]
        self.cfg = json.loads((self.root / entry["file"]).read_text())
        self.mix = json.loads((self.bench_dir / "traffic" /
                               f"{self.workload['traffic']}.json").read_text())
        self.end_to_end = [m for m in self.bench["end_to_end"] if self.reports(m)]
        moves = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in moves)]

    @property
    def name(self) -> str:
        return self.workload["name"]

    def reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def metric_reader(self, metric: dict):
        """The metric's reader module, checked against its entry."""
        mod = load_module(self.bench_dir / "metrics" / f"{metric['name']}.py",
                          "pbmetric_" + metric["name"].replace(".", "_"))
        for key in ("name", "unit", "layer", "source", "moves"):
            if getattr(mod, key.upper()) != metric[key]:
                raise SystemExit(f"metrics/{metric['name']}.py: {key} "
                                 f"{getattr(mod, key.upper())!r} but BENCHMARK.json has "
                                 f"{metric[key]!r}")
        return mod

    def driver(self):
        """The mix's driver module, `drivers/<driver>.py`."""
        name = self.mix.get("driver", "")
        path = self.bench_dir / "drivers" / f"{name}.py"
        if not name.isidentifier() or not path.is_file():
            known = sorted(p.stem for p in (self.bench_dir / "drivers").glob("*.py"))
            raise SystemExit(f"traffic/{self.workload['traffic']}.json: no driver {name!r} "
                             f"(drivers: {known})")
        return load_module(path, "pbdriver_" + name)

    def families(self) -> dict:
        """{"acoustic": module, "vocoder": module} of `reference/`."""
        return {part: load_module(self.bench_dir / "reference" / f"{self.cfg[part]['family']}.py",
                                  "pbref_" + self.cfg[part]["family"])
                for part in ("acoustic", "vocoder")}


def forbidden_loaded(extra: tuple = ()) -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN (or `extra`),
    compared whole."""
    names = set(FORBIDDEN) | set(extra)
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in names})
