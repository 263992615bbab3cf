#!/usr/bin/env python3
"""The acoustic floor's corpus built on two devices, compared file by file.

    python3 tools/corpus_compare_torch.py [--devices cuda,cpu] [--n-per-class 60]
        [--work DIR]

Builds the corpus of `tools/acoustic_floor_torch.py` (the synthetic corpus
of seed 0, formatted, aligned and preprocessed) once per device in
--devices, each in its own directory under --work (default
`build/corpus_compare/`), and prints one JSON line per build: its device,
build seconds, file count and the sha256 of every preprocessed file's
relative path and bytes in sorted order (equal digests: byte-equal builds,
wherever they ran). With two devices it prints one more line comparing the
first build with the second:

- per feature directory (mel, energy, kurtosis, duration, image/width):
  files on one side only, the max absolute and relative difference
  (relative to the larger |value| of the two, over elements with one of
  them above 1e-6), the count of differing elements, and the files that
  differ;
- energy and kurtosis again as the raw values (each saved value times the
  build's std plus its mean, from its `stats.json`): the count of values
  that the per-file IQR outlier cut (`Preprocessor._remove_outlier`)
  removes in one build only;
- every entry of `stats.json` with its two values;
- the split files (train, val, test): rows that lie in another split or in
  none on the other side;
- `symbols.json`, `audiotype.json`, `visual_text.json`,
  `label_width.json` and the PNG images: equal or not.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from acoustic_floor_torch import build_floor_corpus, floor_config  # noqa: E402

FEATURES = ("mel", "energy", "kurtosis", "duration", "image/width")
SPLITS = ("train.txt", "val.txt", "test.txt")
JSONS = ("symbols.json", "audiotype.json", "visual_text.json", "label_width.json")


def digest(root: pathlib.Path) -> tuple[str, int]:
    """sha256 over every file's relative path and bytes, in sorted order."""
    h = hashlib.sha256()
    files = sorted(p for p in root.rglob("*") if p.is_file())
    for p in files:
        h.update(str(p.relative_to(root)).encode() + b"\0" + p.read_bytes())
    return h.hexdigest(), len(files)


def _arrays(root: pathlib.Path, feature: str) -> dict[str, np.ndarray]:
    return {str(p.relative_to(root / feature)): np.load(p)
            for p in sorted((root / feature).rglob("*.npy"))}


def _outlier_kept(values: np.ndarray) -> np.ndarray:
    """`Preprocessor._remove_outlier`'s keep mask."""
    p25, p75 = np.percentile(values, [25, 75])
    lower, upper = p25 - 1.5 * (p75 - p25), p75 + 1.5 * (p75 - p25)
    return np.logical_and(values > lower, values < upper)


def compare_feature(a: pathlib.Path, b: pathlib.Path, feature: str, stats=None) -> dict:
    """One feature directory of two builds (module docstring)."""
    xa, xb = _arrays(a, feature), _arrays(b, feature)
    common = sorted(set(xa) & set(xb))
    out = {"files": len(common), "only_a": len(set(xa) - set(xb)),
           "only_b": len(set(xb) - set(xa)), "shape_mismatch": 0,
           "max_abs": 0.0, "max_rel": 0.0, "elements": 0, "elements_differ": 0,
           "files_differ": 0}
    cut_differ = 0
    for k in common:
        va, vb = xa[k].astype(np.float64), xb[k].astype(np.float64)
        if va.shape != vb.shape:
            out["shape_mismatch"] += 1
            continue
        out["elements"] += va.size
        d = np.abs(va - vb)
        n = int(np.count_nonzero(d))
        out["elements_differ"] += n
        out["files_differ"] += int(n > 0)
        if va.size:
            out["max_abs"] = max(out["max_abs"], float(d.max()))
            scale = np.maximum(np.abs(va), np.abs(vb))
            big = scale > 1e-6
            if big.any():
                out["max_rel"] = max(out["max_rel"], float((d[big] / scale[big]).max()))
        if stats is not None and va.size:
            (_, _, mean_a, std_a), (_, _, mean_b, std_b) = stats
            raw_a, raw_b = va * std_a + mean_a, vb * std_b + mean_b
            cut_differ += int(np.count_nonzero(_outlier_kept(raw_a) != _outlier_kept(raw_b)))
    if stats is not None:
        out["outlier_cut_differ"] = cut_differ
    return out


def compare_builds(a: pathlib.Path, b: pathlib.Path) -> dict:
    """The comparison line of two preprocessed directories."""
    sa = json.loads((a / "stats.json").read_text())
    sb = json.loads((b / "stats.json").read_text())
    res = {"metric": "corpus_compare"}
    for feature in FEATURES:
        stats = (sa[feature], sb[feature]) if feature in sa else None
        res[feature] = compare_feature(a, b, feature, stats)
    res["stats"] = {f"{name}[{i}]": [va, vb] for name in sorted(sa)
                    for i, (va, vb) in enumerate(zip(sa[name], sb[name]))}
    res["stats_differ"] = sum(va != vb for va, vb in res["stats"].values())
    where_a = {row: f for f in SPLITS for row in (a / f).read_text().splitlines()}
    where_b = {row: f for f in SPLITS for row in (b / f).read_text().splitlines()}
    res["split_rows"] = len(where_a)
    res["split_rows_moved"] = sum(where_b.get(r) != f for r, f in where_a.items()) + \
        sum(r not in where_a for r in where_b)
    res["split_order_equal"] = all((a / f).read_bytes() == (b / f).read_bytes() for f in SPLITS)
    for name in JSONS:
        res[f"{name}_equal"] = (a / name).read_bytes() == (b / name).read_bytes()
    pa = {str(p.relative_to(a)): p for p in (a / "image" / "png").rglob("*.png")}
    pb = {str(p.relative_to(b)): p for p in (b / "image" / "png").rglob("*.png")}
    res["png"] = len(pa)
    res["png_differ"] = sum(k not in pb or pa[k].read_bytes() != pb[k].read_bytes()
                            for k in pa) + sum(k not in pa for k in pb)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--n-per-class", type=int, default=60)
    ap.add_argument("--work", default=str(ROOT / "build" / "corpus_compare"))
    args = ap.parse_args(argv)
    devices = args.devices.split(",")
    if len(devices) > 2:
        raise SystemExit("--devices takes one or two devices")
    built = []
    for i, device in enumerate(devices):
        t0 = time.perf_counter()
        cfg, raw_root = floor_config(pathlib.Path(args.work) / f"{i}_{device.replace(':', '')}",
                                     args.n_per_class)
        build_floor_corpus(cfg, raw_root, device)
        pre = pathlib.Path(cfg.path.preprocessed)
        sha, n = digest(pre)
        print(json.dumps({"metric": "corpus_build", "device": device,
                          "n_per_class": args.n_per_class,
                          "build_s": time.perf_counter() - t0, "files": n, "sha256": sha}),
              flush=True)
        built.append(pre)
    if len(built) == 2:
        print(json.dumps({"a": devices[0], "b": devices[1], **compare_builds(*built)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
