"""The port's corpus generator, `format` and `prepare-tg` against the JAX
package's and the examples', byte for byte, on the CPU."""
from __future__ import annotations

import json
import pathlib

import pytest

from visual_onoma_to_wave_tpu.cli import main as jax_cli
from visual_onoma_to_wave_tpu.data import labels as jax_labels
from visual_onoma_to_wave_tpu_torch.cli import main as port_cli
from visual_onoma_to_wave_tpu_torch.data import labels
from visual_onoma_to_wave_tpu_torch.data.synthetic_corpus import build_corpus, work_config

ROOT = pathlib.Path(__file__).resolve().parents[1]


def tree_bytes(root: pathlib.Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_corpus_generator_is_the_examples(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    from train_demo_artifacts import build_corpus as examples_build_corpus
    from train_demo_artifacts import work_config as examples_work_config

    examples_build_corpus(tmp_path / "a", 5, seed=3)
    build_corpus(tmp_path / "b", 5, seed=3)
    a, b = tree_bytes(tmp_path / "a"), tree_bytes(tmp_path / "b")
    assert len(a) == 2 * 5 * 4 and a == b
    ref = examples_work_config(tmp_path, "ono", 7)
    ref.pop("model")
    assert work_config(tmp_path, "ono", 7) == ref


@pytest.mark.parametrize("keep_missing_acc", [False, True])
def test_format_and_prepare_tg_match_jax(tmp_path, keep_missing_acc):
    raw_root, ono_root = build_corpus(tmp_path / "corpus", 4)
    (ono_root / "c1" / "bell" / "002.acc").unlink()      # a clip without ratings
    for side, cli in (("jax", jax_cli), ("port", port_cli)):
        cfg = work_config(tmp_path / side, ono_root, 1)
        path = tmp_path / f"{side}.json"
        path.write_text(json.dumps(cfg))
        extra = ["--keep-missing-acc"] if keep_missing_acc else []
        cli(["format", str(path), str(raw_root)] + extra)
        cli(["prepare-tg", str(path)])
    jax_tree, port_tree = (tree_bytes(tmp_path / side / "formatted") for side in ("jax", "port"))
    assert len(port_tree) > 20 and port_tree == jax_tree


def test_lab_splitting_matches_jax(tmp_path):
    lines = ["0.0000 0.1000 silB\n", "0.1000 0.3500 パン\n", "0.3500 0.4100 ドトカ\n",
             "0.4100 0.5000 sp\n", "0.5000 0.6000  \n", "0.6000 0.9000 シ\n",
             "0.9000 1.0000 silE\n"]

    def plain(result):
        segments, n_chars = result
        return [(s.start, s.end, s.text) for s in segments], n_chars

    assert plain(labels.split_lab_segments(lines)) == plain(jax_labels.split_lab_segments(lines))
    lab = tmp_path / "x.lab"
    lab.write_text("".join(lines))
    assert labels.read_lab(lab)[1] == jax_labels.read_lab(lab)[1] == 6
    with pytest.raises(ValueError):
        labels.read_lab(tmp_path / "x.txt")
