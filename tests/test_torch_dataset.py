"""The port's training data layer against the JAX package's, on the CPU.

A tiny synthetic corpus goes through the port's `format`, `prepare-tg` and
`Preprocessor(device="cpu")`. On it, the port's `OnomaDataset` gives the
JAX `OnomaDataset`'s batch plans, pad shapes and collated arrays exactly
(same bytes), and the port's `ProcessLoader` gives the same batches with 0
workers (in-process) and with 2 spawned workers.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu.cli import load_config as jax_load_config
from visual_onoma_to_wave_tpu.data.dataset import OnomaDataset as JaxDataset
from visual_onoma_to_wave_tpu_torch.config import load_config
from visual_onoma_to_wave_tpu_torch.data.dataset import OnomaDataset, to_device
from visual_onoma_to_wave_tpu_torch.data.formatting import format_dataset
from visual_onoma_to_wave_tpu_torch.data.labels import prepare_textgrids
from visual_onoma_to_wave_tpu_torch.data.loader import ProcessLoader
from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor
from visual_onoma_to_wave_tpu_torch.data.synthetic_corpus import build_corpus, work_config


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and beside the other
    test workers they only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def preprocessed_corpus(root, n_per_class: int = 8, batch_size: int = 2) -> str:
    """The synthetic corpus under `root`, formatted, aligned and preprocessed
    by the port on the CPU; returns the path of its config file."""
    raw_root, ono_root = build_corpus(root, n_per_class)
    cfg = work_config(root, ono_root, 10)
    cfg["dataset"]["valtest_id"] = [1, 3]
    cfg["train"]["optimizer"]["batch_size"] = batch_size
    path = root / "cfg.json"
    path.write_text(json.dumps(cfg))
    config = load_config(path)
    format_dataset(config, raw_root)
    prepare_textgrids(config.path.formatted, list(config.dataset.extract_labels))
    Preprocessor(config, num_workers=1, device="cpu").build(verbose=False)
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return preprocessed_corpus(tmp_path_factory.mktemp("corpus"))


def assert_batches_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if k == "names":
            assert a[k] == b[k]
        else:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("split,sort,drop_last", [("train.txt", True, True),
                                                  ("val.txt", False, False)])
def test_plans_and_batches_equal_jax(corpus, split, sort, drop_last):
    ours = OnomaDataset(split, load_config(corpus), sort=sort, drop_last=drop_last)
    ref = JaxDataset(split, jax_load_config(corpus), sort=sort, drop_last=drop_last)
    assert len(ours) == len(ref) > 0 and ours.symbol_map == ref.symbol_map
    for seed in (1, 2):
        plan = ours.batch_plan(group_size=4, seed=seed)
        assert plan == ref.batch_plan(group_size=4, seed=seed)
        assert ours.plan_pad_shapes(plan) == ref.plan_pad_shapes(plan)
        for chunk in plan:
            assert_batches_equal(ours.load_batch(chunk), ref.load_batch(chunk))
    assert ours.batch_plan(shuffle=False) == ref.batch_plan(shuffle=False)


def test_loader_workers_give_the_same_batches(corpus):
    ds = OnomaDataset("train.txt", load_config(corpus), sort=True, drop_last=True)
    assert len(ds.batch_plan(seed=3)) >= ProcessLoader.MIN_BATCHES_FOR_PROCS
    with ProcessLoader(ds, "train.txt", num_workers=0) as serial:
        assert serial.backend == "serial"
        want = list(serial.epoch(seed=3))
    with ProcessLoader(ds, "train.txt", num_workers=2) as pooled:
        assert pooled.backend == "process"
        got = list(pooled.epoch(seed=3))
    assert len(got) == len(want) == len(ds.batch_plan(seed=3))
    for a, b in zip(got, want):
        assert_batches_equal(a, b)
    assert set(to_device(want[0], "cpu")) == set(want[0]) - {"names", "mel_lens"}
