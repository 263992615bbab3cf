"""Corpus formatting: RWCP-SSD raw audio + onomatopoeia annotations -> the
formatted layout consumed by preprocessing (copy of
visual_onoma_to_wave_tpu/data/formatting.py).

ROW-LEVEL parity with reference scripts/01_format.py (not just same final
split): the formatter writes ALL .ono rows to data.txt — including low
self-confidence ones — and leaves score filtering to the preprocessor's
border check (reference preprocessor.py:232-244: conf < border OR
acc < border), exactly like the reference. A self_score<=3 row gets
others_score=0 (01_format.py:63-72), which then fails the acceptance
border at preprocess time, so the surviving split is identical either way;
writing the row keeps data.txt byte-comparable and `cli doctor --stage
formatted` counts meaningful across frameworks.

Reference semantics reproduced here (01_format.py):
  * .raw (48 kHz/16-bit mono PCM) -> audio/<label>/<basename>.wav where
    basename is the .ono path relative to the corpus root with path
    separators / '|' / '_' all normalized to '-' (:18-21, :29-32);
  * .ono rows `worker_id,onomatopoeia_id,onomatopoeia,self_score` joined
    with .acc rows `onomatopoeia_id,onomatopoeia,rater_worker,score` on the
    (normalized) onomatopoeia_id; the OTHER workers' acceptance scores are
    averaged only when self_score > 3, else others_score stays the integer
    0 (DCASE2020 protocol, :61-72);
  * clips whose .acc file is missing are skipped entirely — the reference
    hard-codes its one known case, particl2/071.acc (:54-59); here any
    missing .acc skips by default, `missing_acc="keep"` writes the rows
    with others_score=0 instead;
  * .lab files renamed to lab/<label>/<basename>-<onomatopoeia_id>.lab
    (:84-89), read from a parallel `*_lab` root when present;
  * per-class text/<label>/data.txt rows (:91-98):
      name|audio_stem|onomatopoeia|label|self_score|others_score
    with self_score written verbatim and others_score via str() — "0" for
    unconfident rows, "0.0" for confident rows with no acc matches.

The formatter registry is pluggable like the reference's dict dispatch
(01_format.py:100-109).
"""
from __future__ import annotations

import os
import pathlib
import shutil
from collections import defaultdict
from typing import Callable

from visual_onoma_to_wave_tpu_torch.config import Config
from visual_onoma_to_wave_tpu_torch.data.audio_io import raw_to_wav


def _normalize_text(text: str) -> str:
    """01_format.py:18-21: path separators, '|' (the data.txt delimiter)
    and '_' (the preprocessor's basename splitter) all become '-'."""
    for x in (os.sep, os.altsep, "|", "_"):
        if x:
            text = text.replace(x, "-")
    return text


def _parse_ono(path: pathlib.Path) -> list[tuple[str, str, str, str]]:
    """Rows of (worker_id, onomatopoeia_id, onomatopoeia, self_score) —
    all kept as strings; scores are written back verbatim like the
    reference (01_format.py:49-51)."""
    rows = []
    for line in path.read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        parts = line.split(",")
        if len(parts) != 4:
            raise ValueError(
                f"{path}: .ono rows are "
                f"worker_id,onomatopoeia_id,onomatopoeia,self_score — "
                f"got {line!r}")
        rows.append((parts[0], parts[1], parts[2], parts[3].strip()))
    return rows


def _parse_acc(path: pathlib.Path) -> dict[str, list[int]]:
    """normalized onomatopoeia_id -> other workers' acceptance scores
    (reference joins on the id, not the worker: 01_format.py:66-70)."""
    scores: dict[str, list[int]] = defaultdict(list)
    for line in path.read_text(encoding="utf-8").splitlines():
        if not line.strip():
            continue
        parts = line.split(",")
        if len(parts) != 4:
            raise ValueError(
                f"{path}: .acc rows are "
                f"onomatopoeia_id,onomatopoeia,worker_id,score — "
                f"got {line!r}")
        scores[_normalize_text(parts[0])].append(int(float(parts[3])))
    return scores


def _resolve_roots(ono_root: pathlib.Path) -> tuple[pathlib.Path, pathlib.Path]:
    """Locate the .ono/.acc tree and the parallel .lab tree.

    The published RWCPSSD_Onomatopoeia archive keeps text and labs in
    sibling roots (01_format.py:10-12):
        <root>/RWCP_SSD_Onomatopoeia_jp/nospeech/drysrc/...    (.ono/.acc)
        <root>/RWCP_SSD_Onomatopoeia_jp_lab/nospeech/drysrc/... (.lab)
    If that layout is absent, both default to ono_root itself (labs next
    to their .ono files).
    """
    text_root = ono_root / "RWCP_SSD_Onomatopoeia_jp" / "nospeech" / "drysrc"
    lab_root = (ono_root / "RWCP_SSD_Onomatopoeia_jp_lab" / "nospeech"
                / "drysrc")
    if not text_root.is_dir():
        text_root = ono_root
    if not lab_root.is_dir():
        lab_root = text_root
    return text_root, lab_root


def format_rwcpssd(
    config: Config,
    audio_dir: str | pathlib.Path,
    ono_dir: str | pathlib.Path | None = None,
    missing_acc: str = "skip",
) -> dict[str, int]:
    """Format the RWCP-SSD corpus into `config.path.formatted`.

    audio_dir:   root of the RWCP-SSD audio download; clips are looked up
                 at <audio_dir>/nospeech/drysrc/<take>/<label>/48khz/
                 <clip>.raw (01_format.py:15,30-31), with a recursive glob
                 fallback for re-arranged layouts
    ono_dir:     root of RWCPSSD_Onomatopoeia (defaults to
                 config.path.corpus); see _resolve_roots for the layout
    missing_acc: "skip" (reference behavior for its known-missing
                 particl2/071.acc — drop every row of a clip with no .acc)
                 or "keep" (write the rows with others_score=0)

    Returns {label: row_count} over data.txt rows actually written.
    """
    if missing_acc not in ("skip", "keep"):
        raise ValueError(f"missing_acc must be 'skip' or 'keep', "
                         f"got {missing_acc!r}")
    out_root = pathlib.Path(config.path.formatted)
    ono_root = pathlib.Path(ono_dir if ono_dir is not None
                            else config.path.corpus)
    text_root, lab_root = _resolve_roots(ono_root)
    audio_root = pathlib.Path(audio_dir)
    audio_drysrc = audio_root / "nospeech" / "drysrc"
    if not audio_drysrc.is_dir():
        audio_drysrc = audio_root
    labels = config.dataset.extract_labels
    counts: dict[str, int] = {}

    for label in labels:
        ono_files = sorted(text_root.glob(f"**/{label}/*.ono"))
        ono_files = [p for p in ono_files if not p.stem.startswith(".")]
        if not ono_files:
            continue
        (out_root / "audio" / label).mkdir(parents=True, exist_ok=True)
        (out_root / "lab" / label).mkdir(parents=True, exist_ok=True)
        (out_root / "text" / label).mkdir(parents=True, exist_ok=True)
        rows = []
        for ono_path in ono_files:
            rel = ono_path.relative_to(text_root)
            basename = _normalize_text(str(rel.with_suffix("")))
            raw_path = audio_drysrc / rel.parent / "48khz" / f"{rel.stem}.raw"
            if not raw_path.exists():
                cands = sorted(
                    audio_root.glob(f"**/{label}/**/{rel.stem}.raw"))
                raw_path = cands[0] if cands else None
            acc_path = ono_path.with_suffix(".acc")
            if not acc_path.exists():
                if missing_acc == "skip":
                    continue  # reference 01_format.py:54-59 (before any
                    # audio conversion — no orphan wav for skipped clips)
                acc = {}
            else:
                acc = _parse_acc(acc_path)

            wav_path = out_root / "audio" / label / f"{basename}.wav"
            if raw_path is not None and not wav_path.exists():
                raw_to_wav(raw_path, wav_path)

            for _worker, ono_id_raw, onomatopoeia, self_score in \
                    _parse_ono(ono_path):
                ono_id = _normalize_text(ono_id_raw)
                onomatopoeia = _normalize_text(onomatopoeia)
                # DCASE protocol (01_format.py:61-72): averaged acceptance
                # only for confident rows; the row is WRITTEN either way
                if int(float(self_score)) > 3:
                    matches = acc.get(ono_id, [])
                    others_score: float | int = (
                        sum(matches) / max(len(matches), 1))
                else:
                    others_score = 0
                name = f"{basename}-{ono_id}"
                lab_src = lab_root / rel.parent / f"{rel.stem}-{ono_id_raw}.lab"
                if lab_src.exists():
                    shutil.copy(lab_src,
                                out_root / "lab" / label / f"{name}.lab")
                rows.append(f"{name}|{basename}|{onomatopoeia}|{label}"
                            f"|{self_score}|{others_score}")
        with open(out_root / "text" / label / "data.txt", "w",
                  encoding="utf-8") as f:
            f.write("\n".join(rows) + ("\n" if rows else ""))
        counts[label] = len(rows)
    return counts


FORMATTERS: dict[str, Callable] = {
    "rwcp-ssd": format_rwcpssd,
}


def format_dataset(config: Config, audio_dir, **kwargs) -> dict[str, int]:
    name = config.dataset.name
    if name not in FORMATTERS:
        raise KeyError(f"unknown dataset {name!r}; known: {list(FORMATTERS)}")
    return FORMATTERS[name](config, audio_dir, **kwargs)
