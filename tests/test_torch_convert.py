"""The port's converters of the reference's PyTorch checkpoints (`cli
convert-acoustic`, `cli convert-vocoder`), on the CPU.

No file is downloaded: each reference checkpoint is built here from random
weights in the reference layout (`module.`-prefixed vTTS state_dict under
`model`, with the buffers the model re-derives and an optimizer entry
beside it; HiFi-GAN V1 under `generator` and melgan-neurips under `model`,
both with weight norm as `weight_g` / `weight_v`). The JAX package's loaders
(`load_torch_acoustic`, `load_torch_generator`, `load_torch_melgan`) and the
port's commands read the same file; their trees must be equal leaf for
leaf, bit for bit. The converted acoustic model and HiFi-GAN V1 then serve
the demo golden requests' inputs through the port's fused step and JAX's,
within the bounds of `tests/test_torch_synthesis.py` (mel 1e-4, waveform
1e-5 absolute).
"""
from __future__ import annotations

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_onoma_to_wave_tpu_torch.bridge import flatten_tree, load_npz, vocoder_state_dict
from visual_onoma_to_wave_tpu_torch.cli import main

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "examples"))
import export_demo_for_torch as export  # noqa: E402

# the published geometry's depths (what JAX's `load_torch_acoustic` reads:
# 4 encoder and 6 decoder layers, 3 VFE convs, 5 PostNet convs) at a small width
MODEL = {"transformer": {"encoder_layer": 4, "decoder_layer": 6, "encoder_head": 2,
                         "decoder_head": 2, "encoder_hidden": 32, "decoder_hidden": 32,
                         "conv_filter_size": 64, "conv_kernel_size": [9, 1]},
         "visual_feature_extractor": {"layer_num": 3}, "variance_predictor": {"filter_size": 32},
         "max_seq_len": 512, "postnet_channels": 32,
         "vocoder_kwargs": {"upsample_initial_channel": 32}}
ATOL = {"postnet_mel": 1e-4, "wav": 1e-5}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomize(sd: dict, rng) -> dict:
    out = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            out[k] = v.clone()
        elif k.endswith("running_var"):
            out[k] = torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        else:
            out[k] = torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32))
    return out


def _weight_norm(sd: dict, rng) -> dict:
    """Every conv weight as the reference's weight-norm pair (g over axis 0)."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and v.ndim == 3:
            p = k[:-len(".weight")]
            out[f"{p}.weight_v"] = v
            out[f"{p}.weight_g"] = torch.from_numpy(
                rng.uniform(0.5, 1.5, (v.shape[0], 1, 1)).astype(np.float32))
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The config (the demo's, at MODEL) and the three reference checkpoints."""
    from visual_onoma_to_wave_tpu_torch.config import DatasetMetadata, load_config
    from visual_onoma_to_wave_tpu_torch.models.hifigan import HiFiGANGenerator
    from visual_onoma_to_wave_tpu_torch.models.melgan import MelGANGenerator
    from visual_onoma_to_wave_tpu_torch.models.vtts import VTTS

    root = tmp_path_factory.mktemp("reference")
    cfg = json.loads((export.DEMO / "config.json").read_text())
    cfg["model"] = MODEL
    cfg["path"]["preprocessed"] = str(export.DEMO / "preprocessed")
    (root / "config.json").write_text(json.dumps(cfg))
    config = load_config(root / "config.json")
    rng = np.random.default_rng(0)
    meta = DatasetMetadata.load(config.path.preprocessed)
    n_vocab = len(json.loads((export.DEMO / "preprocessed" / "symbols.json").read_text()))
    sd = _randomize(VTTS.from_config(config, meta, n_vocab=n_vocab).state_dict(), rng)
    # log(1 + d) near log(11): about ten frames a character, so the mels are not empty
    sd["variance_adaptor.duration_predictor.linear_layer.bias"].fill_(2.4)
    model = {f"module.{k}": v for k, v in sd.items()}
    hidden = MODEL["transformer"]["encoder_hidden"]
    model.update({"module.encoder.position_enc": torch.zeros(1, 513, hidden),
                  "module.decoder.position_enc": torch.zeros(1, 513, hidden),
                  "module.variance_adaptor.energy_bins": torch.linspace(-2, 2, 255)})
    torch.save({"model": model, "optimizer": {"step": 5}, "step": 200000},
               root / "acoustic.pth.tar")
    gen = _weight_norm(_randomize(HiFiGANGenerator(upsample_initial_channel=32).state_dict(),
                                  rng), rng)
    torch.save({"generator": gen}, root / "hifigan.pth.tar")
    mg = _weight_norm(_randomize(MelGANGenerator(ngf=8).state_dict(), rng), rng)
    torch.save({"model": {f"mel2wav.{k}": v for k, v in mg.items()}}, root / "melgan.pth.tar")
    return root, config


def _assert_trees_equal(jax_tree, port_tree) -> None:
    a = flatten_tree(jax.tree.map(np.asarray, jax_tree))
    b = flatten_tree(port_tree)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def test_convert_acoustic_equals_the_jax_loader(reference, capsys):
    from visual_onoma_to_wave_tpu.models.convert_acoustic import load_torch_acoustic

    root, _ = reference
    main(["convert-acoustic", str(root / "acoustic.pth.tar"), str(root / "acoustic.npz")])
    assert "converted" in capsys.readouterr().out
    _assert_trees_equal(load_torch_acoustic(str(root / "acoustic.pth.tar")),
                        load_npz(root / "acoustic.npz"))


@pytest.mark.parametrize("kind,ckpt", [("HiFi-GAN", "hifigan.pth.tar"),
                                       ("MelGAN", "melgan.pth.tar")])
def test_convert_vocoder_equals_the_jax_loader(reference, kind, ckpt):
    from visual_onoma_to_wave_tpu.models.hifigan import load_torch_generator
    from visual_onoma_to_wave_tpu.models.melgan import load_torch_melgan

    root, _ = reference
    out = root / f"{kind}.npz"
    main(["convert-vocoder", str(root / ckpt), str(out), "--kind", kind])
    load = load_torch_melgan if kind == "MelGAN" else load_torch_generator
    _assert_trees_equal(load(str(root / ckpt)), load_npz(out))
    # the tree loads into the port's generator of the family
    from visual_onoma_to_wave_tpu_torch.models.vocoder import get_vocoder

    gen = get_vocoder(kind, **({"ngf": 8} if kind == "MelGAN" else
                               {"upsample_initial_channel": 32}))
    gen.load_state_dict(vocoder_state_dict(kind, load_npz(out)))


def test_converted_checkpoints_synthesize_as_jax(reference):
    """The converted acoustic model and HiFi-GAN V1 through the port's
    Synthesizer and its fused step, against JAX's fused step on the JAX
    loaders' trees, fed the demo golden requests' inputs."""
    from visual_onoma_to_wave_tpu import synthesis as jsynthesis
    from visual_onoma_to_wave_tpu.config import DatasetMetadata as JaxMetadata
    from visual_onoma_to_wave_tpu.models import VTTS as JaxVTTS
    from visual_onoma_to_wave_tpu.models.convert_acoustic import load_torch_acoustic
    from visual_onoma_to_wave_tpu.models.hifigan import load_torch_generator
    from visual_onoma_to_wave_tpu.models.vocoder import get_vocoder as jget_vocoder
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer, make_fused_infer

    root, config = reference
    for args in (["convert-acoustic", str(root / "acoustic.pth.tar"), str(root / "a.npz")],
                 ["convert-vocoder", str(root / "hifigan.pth.tar"), str(root / "v.npz")]):
        main(args)
    synth = Synthesizer.from_checkpoint(load_config(root / "config.json"), str(root / "a.npz"),
                                        str(root / "v.npz"), device="cpu")
    g = dict(np.load(export.OUT / "golden.npz"))
    batch = {k: g[k] for k in ("audiotypes", "texts", "src_lens", "image_cells")}
    out = make_fused_infer(synth.model, synth.vocoder)(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        e_control=torch.from_numpy(g["e_control"]), d_control=torch.from_numpy(g["d_control"]))

    from visual_onoma_to_wave_tpu.cli import load_config as jload_config

    jcfg = jload_config(str(root / "config.json"))
    jmodel = JaxVTTS.from_config(jcfg, JaxMetadata.load(jcfg.path.preprocessed),
                                 n_vocab=len(synth.symbol_map))
    jgen = jget_vocoder("HiFi-GAN", upsample_initial_channel=32)
    ref = jsynthesis.make_fused_infer(jmodel, jgen, True)(
        load_torch_acoustic(str(root / "acoustic.pth.tar")),
        load_torch_generator(str(root / "hifigan.pth.tar")),
        {k: jnp.asarray(v) for k, v in batch.items()},
        e_control=jnp.asarray(g["e_control"]), d_control=jnp.asarray(g["d_control"]))
    np.testing.assert_array_equal(out["mel_lens"].numpy(), np.asarray(ref["mel_lens"]))
    np.testing.assert_array_equal(out["duration_rounded"].numpy(),
                                  np.asarray(ref["duration_rounded"]))
    assert int(out["mel_lens"].min()) > 1          # the waveforms are not empty
    for k, tol in ATOL.items():
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=tol,
                                   err_msg=k)


def test_vocoder_tree_inverts_the_melgan_bridge():
    """`vocoder_tree("MelGAN", ...)` is the inverse of `melgan_state_dict`,
    and a state_dict that is not the melgan-neurips layout is refused."""
    from visual_onoma_to_wave_tpu_torch.bridge import melgan_state_dict, vocoder_tree
    from visual_onoma_to_wave_tpu_torch.models.melgan import MelGANGenerator

    sd = _randomize(MelGANGenerator(ngf=8).state_dict(), np.random.default_rng(1))
    tree = vocoder_tree("MelGAN", sd)
    back = melgan_state_dict(tree)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="MelGAN"):
        vocoder_tree("MelGAN", {**sd, "extra.weight": torch.zeros(1)})
