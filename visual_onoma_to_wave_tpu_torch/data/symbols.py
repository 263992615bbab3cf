"""Vocabulary from the preprocessed split files (copy of
visual_onoma_to_wave_tpu/data/symbols.py).

The symbol set is the sorted union of the characters of train/val/test.txt;
ids start at 1 (0 is PAD). `symbols.json` persists it for serving.
"""
from __future__ import annotations

import json
import pathlib

SYMBOLS_FILE = "symbols.json"


def build_symbol_map(preprocessed_dir: str | pathlib.Path,
                     filenames=("train.txt", "val.txt", "test.txt")) -> dict[str, int]:
    chars: set[str] = set()
    d = pathlib.Path(preprocessed_dir)
    for fn in filenames:
        p = d / fn
        if not p.exists():
            continue
        for line in p.read_text(encoding="utf-8").splitlines():
            if line.strip():
                chars.update(line.split("|")[4].replace("{", "").replace("}", ""))
    return {s: i + 1 for i, s in enumerate(sorted(chars))}


def encode_text(text: str, symbol_map: dict[str, int]) -> list[int]:
    clean = text.replace("{", "").replace("}", "").replace("\n", "")
    return [symbol_map[c] for c in clean]


def save_symbol_map(directory: str | pathlib.Path, symbol_map: dict[str, int]) -> None:
    p = pathlib.Path(directory) / SYMBOLS_FILE
    p.write_text(json.dumps(symbol_map, ensure_ascii=False, sort_keys=True), encoding="utf-8")


def load_symbol_map(directory: str | pathlib.Path) -> dict[str, int] | None:
    """symbols.json of `directory`, or None if absent."""
    p = pathlib.Path(directory) / SYMBOLS_FILE
    if not p.exists():
        return None
    return {k: int(v) for k, v in json.loads(p.read_text(encoding="utf-8")).items()}
