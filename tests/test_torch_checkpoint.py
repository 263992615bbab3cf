"""Checkpoints of the port's trainer, on the CPU.

`bridge.vtts_tree` is the inverse of `vtts_state_dict` (both ways, image and
token models, RGB cells, kurtosis); a checkpoint the port's `Trainer` writes
on a tiny corpus is served by `Synthesizer.from_checkpoint` as it is; and the
same `acoustic.npz`, unflattened into the JAX `VTTS`, gives the port's mels
within 1e-5 (both sides float32, summation order only).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from test_torch_dataset import preprocessed_corpus
from visual_onoma_to_wave_tpu.cli import load_config as jax_load_config
from visual_onoma_to_wave_tpu.config import DatasetMetadata as JaxMetadata
from visual_onoma_to_wave_tpu.models import VTTS as JaxVTTS
from visual_onoma_to_wave_tpu_torch.bridge import (
    flatten_tree,
    load_npz,
    vtts_state_dict,
    vtts_tree,
)
from visual_onoma_to_wave_tpu_torch.config import load_config
from visual_onoma_to_wave_tpu_torch.data.dataset import OnomaDataset, to_device
from visual_onoma_to_wave_tpu_torch.models.vtts import VTTS
from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer
from visual_onoma_to_wave_tpu_torch.training.train_state import eval_step, synth_step
from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer

SMALL = {"transformer": {"encoder_layer": 1, "decoder_layer": 1, "encoder_hidden": 32,
                         "decoder_hidden": 32, "conv_filter_size": 64,
                         "conv_kernel_size": [3, 1]},
         "visual_feature_extractor": {"layer_num": 2}, "variance_predictor": {"filter_size": 32},
         "max_seq_len": 128, "postnet_channels": 32}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and beside the other
    test workers they only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kw", [
    dict(use_image=True, vfe_channels=1),
    dict(use_image=True, vfe_channels=3, is_kurtosis=True),
    dict(use_image=False, multi_audiotype=False),
], ids=["image", "rgb-kurtosis", "tokens"])
def test_vtts_tree_inverts_vtts_state_dict(kw):
    torch.manual_seed(0)
    model = VTTS(n_vocab=9, n_audiotype=3, hidden=16, encoder_layers=1, decoder_layers=2,
                 n_head=2, d_inner=32, ffn_kernel=(3, 1), n_mels=8, cell_hw=(6, 5),
                 vfe_layers=2, vp_filter=16, postnet_dim=16, **kw)
    for name, buf in model.named_buffers():          # non-trivial BatchNorm statistics
        if name.endswith(("running_mean", "running_var")):
            buf.uniform_(0.5, 1.5)
    sd = model.state_dict()
    tree = vtts_tree(sd)
    back = vtts_state_dict(tree)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd if not k.endswith("num_batches_tracked"))
    again = flatten_tree(vtts_tree(back))
    assert again.keys() == flatten_tree(tree).keys()
    assert all(np.array_equal(again[k], v) for k, v in flatten_tree(tree).items())
    assert {"params", "batch_stats"} == tree.keys()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny model trained 3 steps by the port's Trainer on the CPU."""
    root = tmp_path_factory.mktemp("trained")
    path = pathlib.Path(preprocessed_corpus(root, n_per_class=6, batch_size=4))
    cfg = json.loads(path.read_text())
    cfg["model"] = SMALL
    cfg["train"]["max_mel_len"] = 256
    path.write_text(json.dumps(cfg))
    config = load_config(path)
    Trainer(config, device="cpu", loader_workers=0).train(max_steps=3)
    return path, config


def test_checkpoint_is_served_by_the_synthesizer(trained):
    path, config = trained
    ckpt = pathlib.Path(config.path.ckpt)
    assert (ckpt / "symbols.json").exists()
    synth = Synthesizer.from_checkpoint(config, str(ckpt / "3" / "acoustic.npz"), device="cpu")
    result = synth.synthesize("パンドン", "drum")
    assert result.mel.shape[1] == 80 and np.isfinite(result.mel).all()
    assert len(result.durations) == 4


def test_checkpoint_gives_jax_the_same_mels(trained):
    """Teacher-forced (a batch's durations and energies) and free-running, the
    port's model from the checkpoint against the JAX VTTS from the same
    `acoustic.npz`, over the whole padded outputs."""
    path, config = trained
    acoustic = pathlib.Path(config.path.ckpt) / "3" / "acoustic.npz"
    synth = Synthesizer.from_checkpoint(config, str(acoustic), device="cpu")
    jcfg = jax_load_config(str(path))
    jm = JaxVTTS.from_config(jcfg, JaxMetadata.load(jcfg.path.preprocessed),
                             n_vocab=len(synth.symbol_map))
    variables = jax.tree.map(np.asarray, load_npz(acoustic))
    batch = next(OnomaDataset("train.txt", config).batches(shuffle=False))
    inputs = {k: batch[k] for k in ("audiotypes", "texts", "src_lens", "image_cells")}
    _, tf = eval_step(synth.model, to_device(batch, "cpu"))
    fr = synth_step(synth.model, to_device(inputs, "cpu"))
    jtf = jm.apply(variables, **inputs, energy_targets=batch["energies"],
                   duration_targets=batch["durations"], use_image=True, deterministic=True,
                   max_mel_len=batch["mels"].shape[1])
    jfr = jm.apply(variables, **inputs, use_image=True, deterministic=True)
    for ours, ref in ((tf, jtf), (fr, jfr)):
        assert np.array_equal(ours["mel_lens"].numpy(), np.asarray(ref["mel_lens"]))
        for k in ("mel", "postnet_mel", "log_duration_pred", "energy_pred"):
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), rtol=0, atol=1e-5,
                                       err_msg=k)


def test_bf16_compute_raises_before_building(trained):
    path, config = trained
    bf16 = config.replace(train=dataclasses.replace(config.train, compute_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        Trainer(bf16, device="cpu")
