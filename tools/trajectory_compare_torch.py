#!/usr/bin/env python3
"""Two acoustic training runs held against each other snapshot by
snapshot: where their trajectories part.

    python3 tools/trajectory_compare_torch.py --work DIR --run RUN_DIR --ref REF_DIR
        [--out FILE]

`--run` and `--ref` hold the `step_<step>.npz` snapshots that
`tools/acoustic_floor_torch.py --snapshot-every N` wrote under its work
directory's `snapshots/` (for example the card's run and its CPU twin);
`--work` is the floor work
directory whose corpus and `cfg.json` both runs trained on. For every step
present in both, prints one JSON line: the teacher-forced val mel L1
(`Trainer.evaluate(metrics=True)`'s `mel_l1`, evaluated on the CPU from each
snapshot) and the val mel loss of both runs, and for each top-level module
of the model the relative distance ||theta_run - theta_ref||_2 /
||theta_ref||_2 over its parameters (BatchNorm statistics excluded). The
last line applies the rule, whose values were fixed before the runs it
judges and so are constants here, not options:

- s* is the first snapshot at which any module's distance exceeds
  THRESHOLD (1e-3);
- if at s* one module's distance is at least DOMINANCE (10) times that of
  every other module, that module is named (`named_module`); otherwise the
  separation is diffuse (`named_module` null);
- `val_gap_step` is the first snapshot at which the two runs' val mel L1
  differ by more than VAL_GAP (2%) of the reference's.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# the rule of the module docstring
THRESHOLD = 1e-3
DOMINANCE = 10.0
VAL_GAP = 0.02

# each top-level module of `models/vtts.py::VTTS` by its parameters' name prefixes
MODULES = {
    "vfe": ("encoder.VisualFeatureExtractor.",),
    "embeddings": ("encoder.src_word_emb.", "audiotype_emb."),
    "encoder": ("encoder.layer_stack.",),
    "variance_adaptor": ("variance_adaptor.",),
    "decoder": ("decoder.",),
    "mel_linear": ("mel_linear.",),
    "postnet": ("postnet.",),
}


def module_of(name: str) -> str:
    for module, prefixes in MODULES.items():
        if name.startswith(prefixes):
            return module
    raise KeyError(f"parameter {name!r} belongs to no module of the comparison")


def module_distances(run: dict, ref: dict, names) -> dict:
    """{module: ||run - ref||_2 / ||ref||_2} over the parameters `names`
    (float64 sums)."""
    import numpy as np

    diff: dict[str, float] = {}
    norm: dict[str, float] = {}
    for n in names:
        m = module_of(n)
        a, b = run[n].astype(np.float64), ref[n].astype(np.float64)
        diff[m] = diff.get(m, 0.0) + float(np.sum((a - b) ** 2))
        norm[m] = norm.get(m, 0.0) + float(np.sum(b ** 2))
    return {m: (diff[m] / norm[m]) ** 0.5 if norm[m] > 0 else diff[m] ** 0.5 for m in diff}


def apply_rule(lines: list[dict]) -> dict:
    """The rule of the module docstring over the per-snapshot lines."""
    s_star = next((ln for ln in lines if max(ln["distance"].values()) > THRESHOLD), None)
    named = None
    if s_star is not None:
        ranked = sorted(s_star["distance"].items(), key=lambda kv: -kv[1])
        top, rest = ranked[0], ranked[1:]
        if all(top[1] >= DOMINANCE * d for _, d in rest):
            named = top[0]
    gap = next((ln for ln in lines
                if abs(ln["run_mel_l1"] - ln["ref_mel_l1"]) > VAL_GAP * abs(ln["ref_mel_l1"])),
               None)
    return {"metric": "trajectory_rule", "threshold": THRESHOLD, "dominance": DOMINANCE,
            "val_gap": VAL_GAP,
            "s_star": None if s_star is None else s_star["step"],
            "distance_at_s_star": None if s_star is None else s_star["distance"],
            "named_module": named,
            "verdict": ("no separation" if s_star is None else
                        f"named: {named}" if named else "diffuse"),
            "val_gap_step": None if gap is None else gap["step"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work", required=True)
    ap.add_argument("--run", required=True, help="snapshots of the run under test")
    ap.add_argument("--ref", required=True, help="snapshots of the reference run")
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from visual_onoma_to_wave_tpu_torch.config import config_from_dict
    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer

    run_dir, ref_dir = pathlib.Path(args.run), pathlib.Path(args.ref)
    steps = sorted({p.name for p in run_dir.glob("step_*.npz")}
                   & {p.name for p in ref_dir.glob("step_*.npz")})
    if not steps:
        raise SystemExit(f"no snapshot step common to {run_dir} and {ref_dir}")
    cfg = config_from_dict(json.loads((pathlib.Path(args.work) / "cfg.json").read_text()))
    trainer = Trainer(cfg, device="cpu", loader_workers=0)
    model = trainer.state.model
    names = [n for n, _ in model.named_parameters()]

    def val(snapshot: dict) -> dict:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in snapshot.items()},
                              strict=False)
        return trainer.evaluate(metrics=True)

    lines = []
    with open(args.out, "w") if args.out else contextlib.nullcontext() as out:
        def emit(line: dict) -> None:
            for f in (sys.stdout, out):
                if f is not None:
                    print(json.dumps(line), file=f, flush=True)

        for name in steps:
            run, ref = dict(np.load(run_dir / name)), dict(np.load(ref_dir / name))
            v_run, v_ref = val(run), val(ref)
            lines.append({"metric": "trajectory_compare", "step": int(name[5:-4]),
                          "run_mel_l1": v_run["mel_l1"], "ref_mel_l1": v_ref["mel_l1"],
                          "run_val_mel_loss": v_run["mel_loss"],
                          "ref_val_mel_loss": v_ref["mel_loss"],
                          "run_mcd": v_run["mcd"], "ref_mcd": v_ref["mcd"],
                          "distance": module_distances(run, ref, names)})
            emit(lines[-1])
        emit(apply_rule(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
