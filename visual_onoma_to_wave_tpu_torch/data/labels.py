"""Julius .lab parsing, per-character time splitting and TextGrid IO
(copy of visual_onoma_to_wave_tpu/data/labels.py).

`read_lab` splits multi-character labels into equal time subdivisions
(rounded to 4 decimals, reference convert_label.py); `prepare_textgrids` is
the reference's 02_prepare_tg pass (lab -> TextGrid, per-class character
length stats); `read_textgrid` is the preprocessor's alignment input.
"""
from __future__ import annotations

import json
import pathlib
import re
from dataclasses import dataclass

import numpy as np

SILENCE_LABELS = ("sil", "sp", "spn", "silB", "silE", "silb", "sile", "")


@dataclass
class Interval:
    start: float
    end: float
    text: str


def _normalize_label(p: str) -> str:
    """Map blank/space labels to 'sp' (reference convert_label.py:113-116)."""
    return "sp" if p in (" ", "") else p


def split_lab_segments(lines: list[str]) -> tuple[list[Interval], int]:
    """Parse `start end label` lines; split multi-char labels into equal time
    subdivisions (1/2 for 2 chars, 1/3 for 3, rounded to 4 dp — reference
    convert_label.py:135-157). Returns (segments, character_count)."""
    segments: list[Interval] = []
    n_chars = 0
    for line in lines:
        parts = line.lower().split(" ")
        if len(parts) < 3:
            continue
        t0, t1 = float(parts[0]), float(parts[1])
        label = _normalize_label(parts[2].replace("\n", ""))
        # Julius emits sil / silB / silE; keep silence tokens whole
        if label in ("sil", "silb", "sile", "sp"):
            segments.append(Interval(t0, t1, label))
            continue
        chars = list(label)
        k = len(chars)
        if k == 1:
            segments.append(Interval(t0, t1, chars[0]))
        else:
            # equal subdivision with 4-dp rounding of interior boundaries
            bounds = [t0] + [
                t0 + round((t1 - t0) * (i + 1) / k, 4) for i in range(k - 1)
            ] + [t1]
            for i, ch in enumerate(chars):
                segments.append(Interval(bounds[i], bounds[i + 1], ch))
        n_chars += k
    return segments, n_chars


def read_lab(path: str | pathlib.Path) -> tuple[list[Interval], int]:
    path = str(path)
    if not re.search(r"\.lab$", path):
        raise ValueError("read_lab supports only .lab files")
    with open(path) as f:
        lines = [ln for ln in f if ln.strip() != ""]
    return split_lab_segments(lines)


def write_textgrid(segments: list[Interval], path: str | pathlib.Path,
                   tier_name: str = "phones") -> None:
    """A single-IntervalTier TextGrid; silB/silE render as empty text."""
    if not segments:
        raise ValueError(f"no label data for {path}")
    xmax = segments[-1].end
    out = [
        'File type = "ooTextFile"', 'Object class = "TextGrid"', " ", "xmin = 0 ",
        f"xmax = {xmax} ", "tiers? <exists> ", "size = 1 ", "item []: ", "    item [1]: ",
        '        class = "IntervalTier" ', f'        name = "{tier_name}" ',
        "        xmin = 0 ", f"        xmax = {xmax} ",
        f"        intervals: size = {len(segments)} ",
    ]
    for i, seg in enumerate(segments):
        text = "" if seg.text in ("silB", "silE", "silb", "sile") else seg.text
        out += [f"        intervals [{i + 1}]:", f"            xmin = {seg.start} ",
                f"            xmax = {seg.end} ", f'            text = "{text}"']
    with open(path, "w") as f:
        f.write("\n".join(out))


def read_textgrid(path: str | pathlib.Path, tier_name: str = "phones") -> list[Interval]:
    """The named tier's intervals of a long-format TextGrid."""
    with open(path) as f:
        content = f.read()
    tier_block = None
    for block in re.split(r"item \[\d+\]:", content)[1:]:
        m = re.search(r'name\s*=\s*"([^"]*)"', block)
        if m and m.group(1) == tier_name:
            tier_block = block
            break
    if tier_block is None:
        raise KeyError(f"tier {tier_name!r} not found in {path}")
    return [Interval(float(m.group(1)), float(m.group(2)), m.group(3)) for m in re.finditer(
        r"intervals \[\d+\]:\s*"
        r"xmin\s*=\s*([\d.eE+-]+)\s*"
        r"xmax\s*=\s*([\d.eE+-]+)\s*"
        r'text\s*=\s*"([^"]*)"', tier_block)]


def prepare_textgrids(formatted_dir: str | pathlib.Path,
                      labels: list[str] | None = None) -> dict:
    """Convert every lab/<label>/*.lab into TextGrid/<label>/*.TextGrid and
    accumulate per-class character-length stats (mean/median/mode/max/min,
    reference 02_prepare_tg.py:28-53) plus the reference's "all param"
    global (max, min) row.

    Writes formatted_dir/dataset_length.json and returns it.
    """
    root = pathlib.Path(formatted_dir)
    stats: dict[str, dict] = {}
    lab_root = root / "lab"
    if labels is None:
        labels = sorted(p.name for p in lab_root.iterdir() if p.is_dir())
    for label in labels:
        lengths = []
        out_dir = root / "TextGrid" / label
        out_dir.mkdir(parents=True, exist_ok=True)
        for lab_path in sorted((lab_root / label).glob("*.lab")):
            try:
                segments, n_chars = read_lab(lab_path)
            except ValueError:
                continue
            if not segments:
                continue
            write_textgrid(segments, out_dir / f"{lab_path.stem}.TextGrid")
            lengths.append(n_chars)
        if lengths:
            arr = np.asarray(lengths, dtype=np.float64)
            vals, counts = np.unique(arr, return_counts=True)
            stats[label] = {
                "mean": float(arr.mean()),
                "median": float(np.median(arr)),
                "mode": int(vals[np.argmax(counts)]),
                "std": float(arr.std()),
                "max": int(arr.max()),
                "min": int(arr.min()),
                "count": int(arr.size),
            }
    if stats:
        stats["all param"] = {
            "max": max(s["max"] for s in stats.values()),
            "min": min(s["min"] for s in stats.values()),
        }
    with open(root / "dataset_length.json", "w") as f:
        json.dump(stats, f)
    return stats
