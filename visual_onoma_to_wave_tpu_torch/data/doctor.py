"""Corpus integrity checker (copy of visual_onoma_to_wave_tpu/data/doctor.py,
behind `cli doctor`).

`check_corpus` validates a preprocessed directory in one pass, up front,
instead of letting a broken or stale corpus surface as a shape error deep
inside training:

  * metadata files present (audiotype.json / stats.json / visual_text.json /
    label_width.json);
  * every split row's feature files exist, with aligned shapes:
    len(text) == len(duration) == len(energy/kurtosis) == len(widths),
    sum(duration) == mel frames, mel dim == n_mels,
    image width == sum(widths) and image height == fontsize;
  * every character is encodable by the split-derived vocabulary, or by a
    checkpoint's `symbols.json` when one is given;
  * splits are disjoint by clip name;
  * normalized energy/kurtosis are ~standardized when normalization is on.

`check_formatted` validates the formatted corpus (stages 01/02) before
preprocessing. Both return a JSON-ready report whose `ok` is False when a
problem was found; `cli doctor` prints it and exits 1 then. The reports
equal the JAX package's (`tests/test_torch_doctor.py`).
"""
from __future__ import annotations

import json
import pathlib
from typing import Optional

import numpy as np

from visual_onoma_to_wave_tpu_torch.config import Config


def _rows(path: pathlib.Path):
    out = []
    if not path.exists():
        return out
    for ln in path.read_text().splitlines():
        if ln.strip():
            out.append(ln.split("|"))
    return out


def check_corpus(config: Config, limit: Optional[int] = None,
                 max_problems: int = 50,
                 symbols: Optional[dict] = None) -> dict:
    """Validate the preprocessed directory. Returns
    {ok, checked_rows, problems: [...], counts: {...}} with `problems`
    capped at max_problems (the count keeps growing).

    limit: check at most N rows PER SPLIT. symbols: a trained checkpoint's
    saved symbol map (utils symbols.json) — rows are then checked
    encodable against the CHECKPOINT vocabulary, catching a corpus that
    was regenerated after training (the mismatch that breaks serving)."""
    root = pathlib.Path(config.path.preprocessed)
    problems: list[str] = []
    n_problems = 0

    def problem(msg: str) -> None:
        nonlocal n_problems
        n_problems += 1
        if len(problems) < max_problems:
            problems.append(msg)

    # -- metadata --------------------------------------------------------
    meta = {}
    for fn in ("audiotype.json", "stats.json", "visual_text.json",
               "label_width.json"):
        p = root / fn
        if not p.exists():
            problem(f"missing metadata file: {fn}")
            continue
        try:
            meta[fn] = json.loads(p.read_text())
        except ValueError as e:
            problem(f"unparseable {fn}: {e}")
    audiotypes = meta.get("audiotype.json", {})

    splits = {s: _rows(root / f"{s}.txt") for s in ("train", "val", "test")}
    if not splits["train"]:
        problem("train.txt missing or empty")

    # split disjointness by row name
    seen: dict[str, str] = {}
    for split, rows in splits.items():
        for r in rows:
            if r[0] in seen:
                problem(f"row {r[0]} appears in both {seen[r[0]]} and "
                        f"{split}")
            seen[r[0]] = split

    # vocabulary: corpus union (well-formed rows only — malformed rows are
    # reported per-row below, not crashed on), like data/symbols.py builds
    # at train time. When the caller supplies a CHECKPOINT's saved
    # symbol map, rows are checked against THAT — the mismatch that
    # actually breaks serving (a corpus regenerated after training).
    chars: set = set()
    for rows in splits.values():
        for r in rows:
            if len(r) >= 5:
                chars.update(r[4].replace("{", "").replace("}", ""))
    corpus_vocab = {s: i + 1 for i, s in enumerate(sorted(chars))}
    symbol_map = symbols if symbols is not None else corpus_vocab

    n_mels = config.audio.mel.n_mel_channels
    is_energy = config.model.variance_embedding.is_energy_condition
    is_kurtosis = config.model.variance_embedding.is_kurtosis_condition

    checked = 0
    energies, kurtoses = [], []
    for split, rows in splits.items():
        split_checked = 0
        for r in rows:
            if limit is not None and split_checked >= limit:
                break
            split_checked += 1
            if len(r) < 5:
                problem(f"{split}: malformed row {r!r:.80}")
                continue
            name, label, fontsize, _font, text = r[:5]
            checked += 1
            if label not in audiotypes:
                problem(f"{split}:{name}: label {label!r} not in "
                        f"audiotype.json")
            clean = text.replace("{", "").replace("}", "")
            missing = sorted({c for c in clean if c not in symbol_map})
            if missing:
                problem(f"{split}:{name}: unencodable characters "
                        f"{missing}")
            feats = {}
            want = ["mel", "duration"]
            if is_energy:
                want.append("energy")
            if is_kurtosis:
                want.append("kurtosis")
            ok = True
            for kind in want:
                p = root / kind / label / f"{name}.npy"
                if not p.exists():
                    problem(f"{split}:{name}: missing {kind} file")
                    ok = False
                    continue
                try:
                    feats[kind] = np.load(p)
                except Exception as e:
                    problem(f"{split}:{name}: unreadable {kind}: {e}")
                    ok = False
            if not ok or "mel" not in feats or "duration" not in feats:
                continue
            mel, dur = feats["mel"], feats["duration"]
            c = len(clean)
            if mel.ndim != 2 or mel.shape[1] != n_mels:
                problem(f"{split}:{name}: mel shape {mel.shape} != "
                        f"(T, {n_mels})")
            if len(dur) != c:
                problem(f"{split}:{name}: {len(dur)} durations for "
                        f"{c} characters")
            if int(dur.sum()) != mel.shape[0]:
                problem(f"{split}:{name}: durations sum {int(dur.sum())} "
                        f"!= {mel.shape[0]} mel frames")
            for kind in ("energy", "kurtosis"):
                if kind in feats and len(feats[kind]) != c:
                    problem(f"{split}:{name}: {len(feats[kind])} {kind} "
                            f"values for {c} characters")
            if "energy" in feats:
                energies.append(np.asarray(feats["energy"], np.float64))
            if "kurtosis" in feats:
                kurtoses.append(np.asarray(feats["kurtosis"], np.float64))
            if config.train.use_image:
                wp = root / "image" / "width" / label / f"{name}.npy"
                ip = root / "image" / "png" / label / f"{name}.png"
                if not wp.exists() or not ip.exists():
                    problem(f"{split}:{name}: missing image artifacts")
                    continue
                widths = np.load(wp)
                if len(widths) != c:
                    problem(f"{split}:{name}: {len(widths)} cell widths "
                            f"for {c} characters")
                from PIL import Image
                with Image.open(ip) as im:
                    w, h = im.size
                if w != int(widths.sum()):
                    problem(f"{split}:{name}: image width {w} != "
                            f"sum(widths) {int(widths.sum())}")
                try:
                    if h != int(fontsize):
                        problem(f"{split}:{name}: image height {h} != "
                                f"fontsize {fontsize}")
                except ValueError:
                    problem(f"{split}:{name}: non-integer fontsize "
                            f"{fontsize!r}")

    # normalized-feature sanity (pass 4 wrote standardized values in place,
    # reference preprocessor.py:624-645)
    def check_standardized(vals, kind, enabled):
        if not enabled or not vals:
            return
        flat = np.concatenate([v.ravel() for v in vals])
        if flat.size < 16:
            return
        if abs(float(flat.mean())) > 0.75 or not (
                0.25 < float(flat.std()) < 4.0):
            problem(f"{kind} values look un-normalized "
                    f"(mean {flat.mean():.3f}, std {flat.std():.3f}) — "
                    f"was pass 4 run with normalization on?")

    check_standardized(energies, "energy",
                       config.audio.energy_normalization and is_energy)
    check_standardized(kurtoses, "kurtosis",
                       config.audio.kurtosis_normalization and is_kurtosis)

    return {
        "ok": n_problems == 0,
        "checked_rows": checked,
        "n_problems": n_problems,
        "problems": problems,
        "counts": {s: len(r) for s, r in splits.items()},
        "n_vocab": len(corpus_vocab),
        "n_audiotype": len(audiotypes),
    }


def check_formatted(config: Config, max_problems: int = 50) -> dict:
    """Validate the FORMATTED corpus (stage 01/02 outputs) before
    preprocessing: per-label data.txt rows well-formed, and every row that
    passes the score borders has its TextGrid and wav on disk with a
    parseable alignment tier.

    The preprocessor (like the reference, preprocessor.py:366-396) SKIPS
    such rows silently and just counts them — this makes the skips visible
    up front and separates the expected ones (score filters) from the
    suspicious ones (missing/corrupt files)."""
    from visual_onoma_to_wave_tpu_torch.data.labels import SILENCE_LABELS, read_textgrid

    root = pathlib.Path(config.path.formatted)
    problems: list[str] = []
    n_problems = 0

    def problem(msg: str) -> None:
        nonlocal n_problems
        n_problems += 1
        if len(problems) < max_problems:
            problems.append(msg)

    labels = list(config.dataset.extract_labels) or sorted(
        p.name for p in (root / "text").glob("*") if p.is_dir())
    if not labels:
        problem(f"no labels under {root / 'text'}")
    ds = config.dataset
    per_label = {}
    for label in labels:
        stats = {"rows": 0, "score_filtered": 0, "checked": 0}
        per_label[label] = stats
        dt = root / "text" / label / "data.txt"
        if not dt.exists():
            problem(f"{label}: missing text/{label}/data.txt")
            continue
        for ln, line in enumerate(dt.read_text(encoding="utf-8")
                                  .splitlines(), 1):
            if not line.strip():
                continue
            stats["rows"] += 1
            fields = line.split("|")
            if len(fields) != 6:
                problem(f"{label}:data.txt:{ln}: {len(fields)} fields, "
                        f"want 6 (name|audio|text|label|self|others)")
                continue
            name, audio_base, text, _lab, conf, acc = fields
            try:
                passes = (float(conf) >= ds.confidence_score_border
                          and float(acc) >= ds.acceptance_score_border)
            except ValueError:
                problem(f"{label}:{name}: non-numeric scores "
                        f"{conf!r}/{acc!r}")
                continue
            if not passes:
                stats["score_filtered"] += 1
                continue
            stats["checked"] += 1
            tg = root / "TextGrid" / label / f"{name}.TextGrid"
            wav = root / "audio" / label / f"{audio_base}.wav"
            if not tg.exists():
                problem(f"{label}:{name}: missing TextGrid (row passes "
                        f"score borders but will be silently skipped)")
            else:
                try:
                    intervals = read_textgrid(tg)
                    chars = [iv for iv in intervals
                             if iv.text not in SILENCE_LABELS]
                    if len(chars) != len(text):
                        problem(f"{label}:{name}: TextGrid has "
                                f"{len(chars)} character intervals for "
                                f"{len(text)}-char text {text!r}")
                except Exception as e:
                    problem(f"{label}:{name}: unparseable TextGrid: {e}")
            if not wav.exists():
                problem(f"{label}:{name}: missing wav "
                        f"audio/{label}/{audio_base}.wav")
            else:
                import wave as wavmod
                try:
                    with wavmod.open(str(wav)) as w:
                        if w.getnframes() <= 0:
                            problem(f"{label}:{name}: empty wav")
                except Exception as e:
                    problem(f"{label}:{name}: unreadable wav: {e}")

    return {
        "ok": n_problems == 0,
        "n_problems": n_problems,
        "problems": problems,
        "labels": per_label,
    }
