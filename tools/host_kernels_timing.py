#!/usr/bin/env python3
"""Whether the port needs the JAX package's host C kernels
(`visual_onoma_to_wave_tpu/native/datakernels.c`): their times against the
port's numpy twins, on this host's CPU.

    python3 tools/host_kernels_timing.py [--n-per-class 60] [--batch 16]
        [--repeats 5] [--work DIR] [--step-ms 76.79]

A reference-side tool: it imports the JAX package's `native` module (a
ctypes library compiled from the C source on first use), so it is not one of
the port's scripts. Builds the floor tool's synthetic corpus on the CPU
(`tools/acoustic_floor_torch.py`, seed 0; 60 clips a class is the demo
corpus) and times, each as the median of --repeats:

  * per planned train batch of --batch rows: the image cells of every row,
    `data/dataset.py::pad_character_cells` (numpy) against
    `native.pad_cells_u8` on the same strips (equal outputs checked);
  * one `Trainer.evaluate(metrics=True)` of the committed demo acoustic
    model (`examples/checkpoints/demo/torch/acoustic.npz`, trained on this
    corpus, so its free-running mels have their trained lengths) on the val
    split, with the share of it that `metrics.dtw_path` (numpy) takes,
    and `native.dtw_path_f64` on the same cost matrices (equal paths).
    (`fill_cells_f32` has no caller in the JAX package.)

Prints one JSON line per measurement and a last line with the rule's
verdict: port the C file only if a numpy path takes more than 5% of the
step period (--step-ms, chip_smoke phase 13's) or of one evaluate.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def _median_ms(fn, repeats: int) -> float:
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-per-class", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--work", default=None)
    ap.add_argument("--step-ms", type=float, default=76.79,
                    help="the train step period the cells' time is held to")
    args = ap.parse_args(argv)

    import torch
    from PIL import Image

    from acoustic_floor_torch import build_floor_corpus, floor_config
    from visual_onoma_to_wave_tpu import native
    from visual_onoma_to_wave_tpu_torch import metrics
    from visual_onoma_to_wave_tpu_torch.bridge import load_npz, vtts_state_dict
    from visual_onoma_to_wave_tpu_torch.data.dataset import OnomaDataset, pad_character_cells
    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer

    if not native.available():
        raise SystemExit("the native library did not build (no C compiler?)")
    torch.set_num_threads(1)
    work = pathlib.Path(args.work or tempfile.mkdtemp(prefix="host_kernels_"))
    cfg, raw = floor_config(work, args.n_per_class, 1, "demo", args.batch)
    build_floor_corpus(cfg, raw, "cpu")

    ds = OnomaDataset("train.txt", cfg, sort=True, drop_last=True)
    root = pathlib.Path(cfg.path.preprocessed)
    per_batch = {"numpy": [], "native": []}
    plan = ds.batch_plan(4, cfg.train.seed + 1, True)
    for chunk in plan:
        strips = []
        for i in chunk:
            name, audiotype = ds.rows[i][0], ds.rows[i][1]
            widths = np.load(root / "image" / "width" / audiotype / f"{name}.npy").astype(np.int64)
            with Image.open(root / "image" / "png" / audiotype / f"{name}.png") as im:
                strips.append((np.asarray(im.convert("L"), np.uint8), widths))
        for img, w in strips:
            assert np.array_equal(pad_character_cells(img, w, ds.cell_width),
                                  native.pad_cells_u8(img, w, ds.cell_width))
        per_batch["numpy"].append(_median_ms(
            lambda: [pad_character_cells(img, w, ds.cell_width) for img, w in strips],
            args.repeats))
        per_batch["native"].append(_median_ms(
            lambda: [native.pad_cells_u8(img, w, ds.cell_width) for img, w in strips],
            args.repeats))
    cells = {k: float(np.median(v)) for k, v in per_batch.items()}
    cells_share = cells["numpy"] / args.step_ms
    print(json.dumps({"metric": "pad_cells_ms_per_batch", "batch": args.batch,
                      "batches": len(plan), "numpy_ms": cells["numpy"],
                      "native_ms": cells["native"], "step_ms": args.step_ms,
                      "numpy_share_of_step": cells_share}), flush=True)

    trainer = Trainer(cfg, device="cpu", loader_workers=0)
    demo = ROOT / "examples" / "checkpoints" / "demo" / "torch" / "acoustic.npz"
    trainer.state.model.load_state_dict(vtts_state_dict(load_npz(demo)))
    costs: list[np.ndarray] = []
    dtw_ms = [0.0]
    numpy_dtw, dtw = metrics.dtw_path, metrics._dtw

    def timed_dtw(cost):
        costs.append(cost)
        t0 = time.perf_counter()
        out = numpy_dtw(cost)
        dtw_ms[0] += (time.perf_counter() - t0) * 1e3
        return out

    metrics._dtw = timed_dtw          # the evaluate runs the numpy DTW
    try:
        trainer.evaluate(metrics=True)                 # warm
        evals = []
        for _ in range(args.repeats):
            costs.clear()
            dtw_ms[0] = 0.0
            t0 = time.perf_counter()
            trainer.evaluate(metrics=True)
            evals.append(((time.perf_counter() - t0) * 1e3, dtw_ms[0]))
    finally:
        metrics._dtw = dtw
    for c in costs:
        a, b = numpy_dtw(c), native.dtw_path_f64(c)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    native_ms = _median_ms(lambda: [native.dtw_path_f64(c) for c in costs], args.repeats)
    eval_ms = float(np.median([e for e, _ in evals]))
    numpy_dtw_ms = float(np.median([d for _, d in evals]))
    dtw_share = numpy_dtw_ms / eval_ms
    print(json.dumps({"metric": "dtw_ms_per_evaluate", "val_clips": len(costs),
                      "shapes": [list(c.shape) for c in costs], "evaluate_ms": eval_ms,
                      "numpy_dtw_ms": numpy_dtw_ms, "native_dtw_ms": native_ms,
                      "numpy_share_of_evaluate": dtw_share}), flush=True)
    port = cells_share > 0.05 or dtw_share > 0.05
    print(json.dumps({"metric": "host_kernels_verdict", "rule": "port if a numpy path > 5%",
                      "cells_share_of_step": cells_share, "dtw_share_of_evaluate": dtw_share,
                      "port_the_c_file": port}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
