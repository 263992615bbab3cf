"""`data/doctor.py` and `cli doctor` of the port against the JAX package's, on the CPU.

The corpus is the examples' synthetic one (`data/synthetic_corpus.py`, 2 x 6
clips), formatted, aligned and preprocessed by the port. Each case copies it,
breaks the copy in one way (or not at all) and holds the port's report to
JAX's on the same directories: the two reports are equal as dicts. The
broken copies: a missing feature file, overlapping splits, a duration sum
off the mel length, unnormalised energy, a missing TextGrid (the formatted
stage), a checkpoint's `symbols.json` that cannot encode a row. The CLI's
exit codes: 0 on the clean corpus, 1 with a report on a broken one, and an
exit naming the directory for a `--ckpt` without `symbols.json`.
"""
from __future__ import annotations

import json
import pathlib
import shutil

import numpy as np
import pytest

from test_torch_dataset import preprocessed_corpus
from visual_onoma_to_wave_tpu.cli import load_config as jax_load_config
from visual_onoma_to_wave_tpu.data import doctor as jdoctor
from visual_onoma_to_wave_tpu_torch.cli import main
from visual_onoma_to_wave_tpu_torch.config import load_config
from visual_onoma_to_wave_tpu_torch.data import doctor


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("doctor")
    return pathlib.Path(preprocessed_corpus(root, n_per_class=6, batch_size=4)).parent


def _copy(corpus: pathlib.Path, dst: pathlib.Path) -> pathlib.Path:
    """The corpus's formatted and preprocessed trees and its config under `dst`."""
    for sub in ("formatted", "preprocessed"):
        shutil.copytree(corpus / sub, dst / sub)
    cfg = (corpus / "cfg.json").read_text().replace(str(corpus), str(dst))
    (dst / "cfg.json").write_text(cfg)
    return dst / "cfg.json"


def _first(pre: pathlib.Path, kind: str) -> pathlib.Path:
    return sorted((pre / kind).glob("*/*.npy"))[0]


def _missing_feature(pre):
    _first(pre, "energy").unlink()


def _overlapping_splits(pre):
    train = (pre / "train.txt").read_text().splitlines()
    (pre / "val.txt").write_text((pre / "val.txt").read_text() + train[0] + "\n")


def _duration_off(pre):
    p = _first(pre, "duration")
    d = np.load(p)
    d[0] += 2
    np.save(p, d)


def _unnormalized_energy(pre):
    for p in (pre / "energy").glob("*/*.npy"):
        np.save(p, np.load(p) * 300.0 + 500.0)


def _missing_textgrid(pre):
    sorted((pre.parent / "formatted" / "TextGrid").glob("*/*.TextGrid"))[0].unlink()


CASES = {"clean": (None, "preprocessed", None),
         "missing-feature": (_missing_feature, "preprocessed", "missing energy"),
         "overlapping-splits": (_overlapping_splits, "preprocessed", "appears in both"),
         "duration-sum-off": (_duration_off, "preprocessed", "durations sum"),
         "unnormalized-energy": (_unnormalized_energy, "preprocessed", "un-normalized"),
         "clean-formatted": (None, "formatted", None),
         "missing-textgrid": (_missing_textgrid, "formatted", "missing TextGrid"),
         "ckpt-symbols": (None, "ckpt", "unencodable")}


@pytest.mark.parametrize("case", list(CASES))
def test_reports_equal_the_jax_doctor(corpus, tmp_path, case):
    breaker, stage, needle = CASES[case]
    path = _copy(corpus, tmp_path)
    cfg, jcfg = load_config(path), jax_load_config(str(path))
    if breaker is not None:
        breaker(pathlib.Path(cfg.path.preprocessed))
    if stage == "formatted":
        got, want = doctor.check_formatted(cfg), jdoctor.check_formatted(jcfg)
        assert sum(v["checked"] for v in got["labels"].values()) > 0
    else:
        # a checkpoint trained before one of the corpus's characters existed
        symbols = ({c: i for c, i in json.loads((pathlib.Path(cfg.path.preprocessed)
                                                  / "symbols.json").read_text()).items()
                    if c != "ン"} if stage == "ckpt" else None)
        got = doctor.check_corpus(cfg, symbols=symbols)
        want = jdoctor.check_corpus(jcfg, symbols=symbols)
        assert got["checked_rows"] > 0
    assert got == want
    assert got["ok"] is (needle is None)
    if needle is not None:
        assert any(needle in p for p in got["problems"]), got["problems"]


def test_limit_is_per_split_as_jax(corpus, tmp_path):
    path = _copy(corpus, tmp_path)
    got = doctor.check_corpus(load_config(path), limit=2)
    assert got == jdoctor.check_corpus(jax_load_config(str(path)), limit=2)
    assert got["checked_rows"] == 2 * sum(1 for n in got["counts"].values() if n)


def test_cli_doctor_exit_codes(corpus, tmp_path, capsys):
    path = _copy(corpus, tmp_path)
    assert main(["doctor", str(path)]) is None
    assert json.loads(capsys.readouterr().out)["ok"]
    assert main(["doctor", str(path), "--stage", "formatted", "--limit", "1"]) is None
    assert json.loads(capsys.readouterr().out)["ok"]
    _duration_off(pathlib.Path(load_config(path).path.preprocessed))
    with pytest.raises(SystemExit) as e:
        main(["doctor", str(path)])
    assert e.value.code == 1
    report = json.loads(capsys.readouterr().out)
    assert not report["ok"] and report["n_problems"] == 1
    with pytest.raises(SystemExit) as e:
        main(["doctor", str(path), "--ckpt", str(tmp_path / "nockpt")])
    assert "no symbols.json under" in str(e.value.code) and "nockpt" in str(e.value.code)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "symbols.json").write_text(json.dumps({"パ": 1}))
    with pytest.raises(SystemExit) as e:
        main(["doctor", str(path), "--ckpt", str(ckpt)])
    assert e.value.code == 1
    assert any("unencodable" in p for p in json.loads(capsys.readouterr().out)["problems"])
