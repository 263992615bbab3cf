"""The system under test, built from a configuration file: the port's
`Synthesizer` over its `VTTS` and generator, with the benchmark's weights.

This is the only module of the benchmark that imports the port; the
reference and the rest of the yardstick do not. The port's one acoustic
model (`VTTS`) takes the configuration's "acoustic" group; its vocoder is
the one the file names ("vocoder_model", a name of the port's
`get_vocoder`) with the "vocoder" group's keys that "vocoder_kwargs" lists,
so a configuration with another of the port's vocoders needs no edit here.
"""
from __future__ import annotations

import string

import torch

from pbcore import traffic

def port_config(cfg: dict):
    """The port's `config.Config` for a benchmark configuration."""
    from visual_onoma_to_wave_tpu_torch.config import config_from_dict

    ac, v = cfg["acoustic"], cfg["vocoder"]
    kwargs = {k: v[k] for k in cfg["vocoder_kwargs"]}
    kwargs["dtype"] = v["dtype"]
    return config_from_dict({
        "path": {"font": ac["font"]},
        "visual_text": {"fontsize": ac["fontsize"]},
        "audio": {"sampling_rate": ac["sampling_rate"],
                  "stft": {"hop_length": ac["hop_length"]},
                  "mel": {"n_mel_channels": ac["n_mels"]}},
        "model": {
            "transformer": {"encoder_layer": ac["encoder_layers"], "encoder_head": ac["heads"],
                            "encoder_hidden": ac["hidden"], "decoder_layer": ac["decoder_layers"],
                            "decoder_head": ac["heads"], "decoder_hidden": ac["hidden"],
                            "conv_filter_size": ac["d_inner"],
                            "conv_kernel_size": list(ac["ffn_kernel"])},
            "visual_feature_extractor": {"conv_kernel_size": list(ac["vfe_kernel"]),
                                         "layer_num": ac["vfe_layers"]},
            "variance_predictor": {"filter_size": ac["vp_filter"],
                                   "kernel_size": ac["vp_kernel"]},
            "variance_embedding": {"n_bins": ac["n_bins"],
                                   "energy_quantization": ac["energy_quantization"]},
            "max_seq_len": ac["max_seq_len"],
            "postnet_channels": ac["postnet_dim"],
            "vocoder_model": cfg["vocoder_model"],
            "vocoder_kwargs": kwargs,
        },
        "train": {"compute_dtype": ac["dtype"], "max_mel_len": ac["max_mel_len"],
                  "use_image": True},
    })


def metadata(cfg: dict):
    from visual_onoma_to_wave_tpu_torch.config import DatasetMetadata, FeatureStats

    md, (h, w) = cfg["metadata"], cfg["acoustic"]["cell_hw"]
    return DatasetMetadata(
        audiotype_map={a: i for i, a in enumerate(md["audiotypes"])},
        energy_stats=FeatureStats.from_list(md["energy_stats"]),
        kurtosis_stats=FeatureStats.from_list(md["kurtosis_stats"]),
        max_pixelsize=w, image_height=h, label_width={})


def symbol_map(n_vocab: int) -> dict[str, int]:
    """An image-path vocabulary: the katakana the traffic writes in, then
    letters, ids from 1 (the ids are not read on the image path)."""
    chars = list(traffic.KATAKANA) + list(string.ascii_letters)
    return {c: i + 1 for i, c in enumerate(chars[:n_vocab - 1])}


def build(cfg: dict, acoustic_weights: dict, vocoder_weights: dict, device):
    """The port's Synthesizer on `device` (one device, no sharding)."""
    from visual_onoma_to_wave_tpu_torch.models import VTTS, get_vocoder
    from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer

    config, md = port_config(cfg), metadata(cfg)
    with torch.device(device):     # the constructors' own init runs on the device
        model = VTTS.from_config(config, md, n_vocab=cfg["n_vocab"]).to(device)
        gen = get_vocoder(config.model.vocoder_model,
                          **dict(config.model.vocoder_kwargs)).to(device)
    model.load_state_dict(acoustic_weights)
    gen.load_state_dict(vocoder_weights)
    return Synthesizer(config, model, md, symbol_map(cfg["n_vocab"]), gen, device=device,
                       devices=None)


def build_kernels(cfg: dict) -> None:
    """Build the configuration's CUDA sources, together (nvcc each)."""
    from visual_onoma_to_wave_tpu_torch.ops.cuda_build import build_libraries

    build_libraries(tuple(cfg["kernels"]))

