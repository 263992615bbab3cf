"""Typed configuration of the port (copy of visual_onoma_to_wave_tpu/config.py).

One dataclass schema with the ICASSP values as defaults, the same fields as
the JAX package's, so one config file (JSON, YAML, or the reference's
three-YAML directory) loads to the same values in both packages. Also the
preprocessed-dataset metadata (`DatasetMetadata`) and `load_config`, the
reference CLI's loader (visual_onoma_to_wave_tpu/cli.py:23). `yaml` is
imported only where a YAML file is read.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass(frozen=True)
class PathsConfig:
    corpus: str = "./corpus/RWCP-SSD"
    formatted: str = "./formatted_data/RWCP-SSD"
    preprocessed: str = "./preprocessed_data/RWCP-SSD/latest"
    font: str = "./font/ipaexg00401/ipaexg.ttf"
    ckpt: str = "./outputs/RWCP-SSD/latest/ckpt"
    log: str = "./outputs/RWCP-SSD/latest/log"
    result: str = "./outputs/RWCP-SSD/latest/result"


@dataclass(frozen=True)
class DatasetConfig:
    name: str = "rwcp-ssd"
    extract_labels: tuple[str, ...] = (
        "coffmill", "cup1", "clock1", "whistle3", "maracas",
        "drum", "shaver", "trashbox", "tear", "bells5",
    )
    valtest_id: tuple[int, ...] = (13, 33, 53, 73, 93)
    confidence_score_border: float = 3.0
    acceptance_score_border: float = 2.5


@dataclass(frozen=True)
class VisualTextConfig:
    fontsize: int = 24
    stride: int = 1
    image_stretching: bool = True
    background_color: tuple[int, int, int] = (255, 255, 255)
    text_color: tuple[int, int, int] = (0, 0, 0)
    scale_in_training: str = "gray-scale"  # or "RGB-scale"


@dataclass(frozen=True)
class StftConfig:
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    margin_frame: int = 5


@dataclass(frozen=True)
class MelConfig:
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0


@dataclass(frozen=True)
class AudioConfig:
    sampling_rate: int = 22050
    max_wav_value: float = 32768.0
    stft: StftConfig = field(default_factory=StftConfig)
    mel: MelConfig = field(default_factory=MelConfig)
    energy_normalization: bool = True
    kurtosis_normalization: bool = True


@dataclass(frozen=True)
class AugmentationConfig:
    max_length: int = 7
    repeat_num: int = 3
    consecutive_num: int = 5
    first_consecutive: int = 0


@dataclass(frozen=True)
class TransformerConfig:
    encoder_layer: int = 4
    encoder_head: int = 2
    encoder_hidden: int = 256
    decoder_layer: int = 6
    decoder_head: int = 2
    decoder_hidden: int = 256
    conv_filter_size: int = 1024
    conv_kernel_size: tuple[int, int] = (9, 1)
    encoder_dropout: float = 0.2
    decoder_dropout: float = 0.2


@dataclass(frozen=True)
class VFEConfig:
    conv_kernel_size: tuple[int, int] = (3, 3)
    layer_num: int = 3


@dataclass(frozen=True)
class VariancePredictorConfig:
    filter_size: int = 256
    kernel_size: int = 3
    dropout: float = 0.5


@dataclass(frozen=True)
class VarianceEmbeddingConfig:
    is_kurtosis_condition: bool = False
    is_energy_condition: bool = True
    kurtosis_quantization: str = "linear"
    energy_quantization: str = "linear"
    n_bins: int = 256


@dataclass(frozen=True)
class ModelConfig:
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    visual_feature_extractor: VFEConfig = field(default_factory=VFEConfig)
    variance_predictor: VariancePredictorConfig = field(default_factory=VariancePredictorConfig)
    variance_embedding: VarianceEmbeddingConfig = field(default_factory=VarianceEmbeddingConfig)
    multi_audiotype: bool = True
    max_seq_len: int = 1000
    vocoder_model: str = "HiFi-GAN"
    vocoder_speaker: str = "universal"
    postnet_channels: int = 512
    # generator architecture overrides (e.g. upsample_initial_channel); {} =
    # the family's published architecture
    vocoder_kwargs: dict = field(default_factory=dict)
    # read by the JAX package only (its TPU attention kernel); the port runs
    # its attention kernel on every call
    fused_attention: bool = False


@dataclass(frozen=True)
class OptimizerConfig:
    batch_size: int = 12
    betas: tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-9
    weight_decay: float = 0.0
    grad_clip_thresh: float = 1.0
    grad_acc_step: int = 1
    warm_up_step: int = 4000
    anneal_steps: tuple[int, ...] = (300000, 400000, 500000)
    anneal_rate: float = 0.3
    init_lr: float = 0.001


@dataclass(frozen=True)
class StepConfig:
    total_step: int = 200000
    log_step: int = 100
    synth_step: int = 1000
    val_step: int = 1000
    save_step: int = 10000
    val_metrics: bool = False


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    step: StepConfig = field(default_factory=StepConfig)
    data_parallel_devices: int = 0
    use_image: bool = True
    seed: int = 1234
    # "float32" is what the port serves (`VTTS.from_config` refuses others)
    compute_dtype: str = "float32"
    max_text_len: int = 24
    max_mel_len: int = 1000


@dataclass(frozen=True)
class Config:
    path: PathsConfig = field(default_factory=PathsConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    input_type: str = "visual-text"
    visual_text: VisualTextConfig = field(default_factory=VisualTextConfig)
    audio: AudioConfig = field(default_factory=AudioConfig)
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str | pathlib.Path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=str)


def _tupleize(value: Any) -> Any:
    if isinstance(value, list):
        return tuple(_tupleize(v) for v in value)
    if isinstance(value, dict):
        return {k: _tupleize(v) for k, v in value.items()}
    return value


def _build(cls, data: dict):
    """Recursively build a dataclass from a (partial) dict, keeping defaults."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        ftype = globals().get(f.type) if isinstance(f.type, str) else f.type
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            kwargs[f.name] = _build(ftype, v)
        else:
            kwargs[f.name] = _tupleize(v)
    return cls(**kwargs)


def config_from_dict(data: dict) -> Config:
    return _build(Config, data)


def load_yaml_configs(preprocess_yaml: str | None = None, model_yaml: str | None = None,
                      train_yaml: str | None = None) -> Config:
    """The reference's three-YAML layout (preprocess/model/train) as one Config."""
    import yaml

    data: dict[str, Any] = {}
    if preprocess_yaml is not None:
        with open(preprocess_yaml) as f:
            p = yaml.safe_load(f)
        path = p.get("path", {})
        data["path"] = {
            "corpus": path.get("corpus", path.get("corpus_path", PathsConfig.corpus)),
            "formatted": path.get("formatted", path.get("formatted_data_path",
                                                        PathsConfig.formatted)),
            "preprocessed": path.get("preprocessed", path.get("preprocessed_path",
                                                              PathsConfig.preprocessed)),
            "font": path.get("font", PathsConfig.font),
        }
        data["dataset"] = p.get("dataset", {})
        if "input_type" in p:
            data["input_type"] = p["input_type"]
        vt = p.get("visual_text", {})
        if vt:
            data["visual_text"] = {
                "fontsize": vt.get("fontsize", 24),
                "stride": vt.get("stride", 1),
                "image_stretching": vt.get("image_stretching", True),
                "background_color": vt.get("color", {}).get("background", (255, 255, 255)),
                "text_color": vt.get("color", {}).get("text", (0, 0, 0)),
                "scale_in_training": vt.get("scale_in_training", "gray-scale"),
            }
        au = p.get("audio", {})
        if au:
            feature = au.get("feature", {})
            data["audio"] = {
                "sampling_rate": au.get("sampling_rate", 22050),
                "max_wav_value": au.get("max_wav_value", 32768.0),
                "stft": au.get("stft", {}),
                "mel": au.get("mel", {}),
                "energy_normalization": feature.get("energy", {}).get("normalization", True),
                "kurtosis_normalization": feature.get("kurtosis", {}).get("normalization", True),
            }
        if "augmentation" in p:
            data["augmentation"] = p["augmentation"]
    if model_yaml is not None:
        with open(model_yaml) as f:
            m = yaml.safe_load(f)
        data["model"] = {
            "transformer": m.get("transformer", {}),
            "visual_feature_extractor": m.get("visual_feature_extractor", {}),
            "variance_predictor": m.get("variance_predictor", {}),
            "variance_embedding": m.get("variance_embedding", {}),
            "multi_audiotype": m.get("multi_audiotype", True),
            "max_seq_len": m.get("max_seq_len", 1000),
            "vocoder_model": m.get("vocoder", {}).get("model", "HiFi-GAN"),
            "vocoder_speaker": m.get("vocoder", {}).get("speaker", "universal"),
        }
    if train_yaml is not None:
        with open(train_yaml) as f:
            t = yaml.safe_load(f)
        path = t.get("path", {})
        data.setdefault("path", {})
        data["path"].update({
            "ckpt": path.get("ckpt_path", PathsConfig.ckpt),
            "log": path.get("log_path", PathsConfig.log),
            "result": path.get("result_path", PathsConfig.result),
        })
        data["train"] = {"optimizer": t.get("optimizer", {}), "step": t.get("step", {}),
                         "use_image": t.get("use_image", True)}
    return config_from_dict(data)


def load_config(path: str | pathlib.Path) -> Config:
    """A Config from a JSON or YAML file, or from a directory of the
    reference's preprocess.yaml / model.yaml / train.yaml."""
    p = pathlib.Path(path)
    if p.is_dir():
        files = [p / f"{name}.yaml" for name in ("preprocess", "model", "train")]
        return load_yaml_configs(*(str(f) if f.exists() else None for f in files))
    if p.suffix == ".json":
        with open(p) as f:
            return config_from_dict(json.load(f))
    if p.suffix in (".yaml", ".yml"):
        import yaml

        with open(p) as f:
            return config_from_dict(yaml.safe_load(f))
    raise SystemExit(f"unsupported config path {path}")


@dataclass(frozen=True)
class FeatureStats:
    """min/max/mean/std of a normalised scalar feature (a stats.json entry)."""
    min: float
    max: float
    mean: float
    std: float

    @classmethod
    def from_list(cls, v: Sequence[float]) -> "FeatureStats":
        return cls(min=float(v[0]), max=float(v[1]), mean=float(v[2]), std=float(v[3]))

    def to_list(self) -> list[float]:
        return [self.min, self.max, self.mean, self.std]


@dataclass(frozen=True)
class DatasetMetadata:
    """audiotype.json, stats.json, visual_text.json and label_width.json of a
    preprocessed directory."""
    audiotype_map: dict[str, int]
    energy_stats: FeatureStats
    kurtosis_stats: FeatureStats
    max_pixelsize: int
    image_height: int
    label_width: dict[str, tuple[float, float, float]]
    glyph_source: str | None = None
    font_name: str | None = None

    @classmethod
    def load(cls, preprocessed_dir: str | pathlib.Path) -> "DatasetMetadata":
        d = pathlib.Path(preprocessed_dir)
        with open(d / "audiotype.json") as f:
            audiotype_map = json.load(f)
        with open(d / "stats.json") as f:
            stats = json.load(f)
        with open(d / "visual_text.json") as f:
            vt = json.load(f)
        label_width = {}
        if (d / "label_width.json").exists():
            with open(d / "label_width.json") as f:
                label_width = {k: tuple(v) for k, v in json.load(f).items()}
        return cls(
            audiotype_map=audiotype_map,
            energy_stats=FeatureStats.from_list(stats["energy"]),
            kurtosis_stats=FeatureStats.from_list(stats["kurtosis"]),
            max_pixelsize=int(vt["max_pixelsize"][0]),
            image_height=int(vt["height"][0]),
            label_width=label_width,
            glyph_source=(vt.get("glyph_source") or [None])[0],
            font_name=(vt.get("font") or [None])[0],
        )

    def save(self, preprocessed_dir: str | pathlib.Path) -> None:
        d = pathlib.Path(preprocessed_dir)
        d.mkdir(parents=True, exist_ok=True)
        with open(d / "audiotype.json", "w") as f:
            json.dump(self.audiotype_map, f)
        with open(d / "stats.json", "w") as f:
            json.dump({"energy": self.energy_stats.to_list(),
                       "kurtosis": self.kurtosis_stats.to_list()}, f)
        with open(d / "visual_text.json", "w") as f:
            vt = {"max_pixelsize": [self.max_pixelsize], "height": [self.image_height]}
            if self.glyph_source is not None:
                vt["glyph_source"] = [self.glyph_source]
            if self.font_name is not None:
                vt["font"] = [self.font_name]
            json.dump(vt, f)
        with open(d / "label_width.json", "w") as f:
            json.dump({k: list(v) for k, v in self.label_width.items()}, f)

    @property
    def n_audiotype(self) -> int:
        return len(self.audiotype_map)
