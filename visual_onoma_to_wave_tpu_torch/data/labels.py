"""TextGrid reading and writing (the part of visual_onoma_to_wave_tpu/data/labels.py
that preprocessing uses).

`read_textgrid` is the preprocessor's alignment input; `write_textgrid`
writes the same long format (a corpus for a test or a benchmark).
"""
from __future__ import annotations

import pathlib
import re
from dataclasses import dataclass

SILENCE_LABELS = ("sil", "sp", "spn", "silB", "silE", "silb", "sile", "")


@dataclass
class Interval:
    start: float
    end: float
    text: str


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
