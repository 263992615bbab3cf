"""The port's own host modules against the JAX package's originals, on the CPU.

The port keeps copies of the host modules it needs (config, symbols, audio
I/O, labels, alignment, renderer, the preprocessor's host helpers, the HTTP
server's limits and validation), so that it imports nothing of the JAX
package. Each copy must behave as its original: the same config file loads
to equal dataclasses, rendered cells and saved images are bit-equal, symbol
maps and encodings are equal, wav bytes are byte-equal, TextGrids and
alignments are equal.
"""
from __future__ import annotations

import dataclasses
import pathlib

import numpy as np
import pytest

from visual_onoma_to_wave_tpu import config as jconfig
from visual_onoma_to_wave_tpu import serve as jserve
from visual_onoma_to_wave_tpu.cli import load_config as jload_config
from visual_onoma_to_wave_tpu.data import alignment as jalignment
from visual_onoma_to_wave_tpu.data import audio_io as jaudio_io
from visual_onoma_to_wave_tpu.data import labels as jlabels
from visual_onoma_to_wave_tpu.data import preprocess as jpreprocess
from visual_onoma_to_wave_tpu.data import renderer as jrenderer
from visual_onoma_to_wave_tpu.data import symbols as jsymbols
from visual_onoma_to_wave_tpu_torch import config, serve
from visual_onoma_to_wave_tpu_torch.data import (
    alignment,
    audio_io,
    labels,
    preprocess,
    renderer,
    symbols,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DEMO = ROOT / "examples" / "checkpoints" / "demo"
TEXTS = ["パンパン", "チパチパチパ", "バウバウ", "ab", "シトパリ"]


@pytest.mark.parametrize("path", [DEMO / "config.json", DEMO / "config_vocos.json",
                                  DEMO / "config_istftnet.json", ROOT / "configs" / "icassp.yaml"],
                         ids=lambda p: p.name)
def test_config_files_load_to_equal_dataclasses(path):
    assert dataclasses.asdict(config.load_config(path)) == \
        dataclasses.asdict(jload_config(str(path)))


def test_three_yaml_directory_loads_equal(tmp_path):
    (tmp_path / "preprocess.yaml").write_text(
        "path: {corpus_path: /c, formatted_data_path: /f, preprocessed_path: /p}\n"
        "dataset: {extract_labels: [drum, bell], valtest_id: [13]}\n"
        "visual_text: {fontsize: 20, color: {background: [250, 250, 250]}}\n"
        "audio: {sampling_rate: 16000, stft: {hop_length: 200}, "
        "feature: {energy: {normalization: false}}}\n"
        "augmentation: {repeat_num: 2}\n")
    (tmp_path / "model.yaml").write_text(
        "transformer: {encoder_layer: 3}\nvocoder: {model: MelGAN}\nmax_seq_len: 500\n")
    (tmp_path / "train.yaml").write_text(
        "path: {ckpt_path: /k}\noptimizer: {batch_size: 4}\nuse_image: false\n")
    got, want = config.load_config(tmp_path), jload_config(str(tmp_path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.model.vocoder_model == "MelGAN" and got.audio.stft.hop_length == 200


def test_dataset_metadata_loads_equal():
    got = config.DatasetMetadata.load(DEMO / "preprocessed")
    want = jconfig.DatasetMetadata.load(DEMO / "preprocessed")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_audiotype == want.n_audiotype


@pytest.mark.parametrize("grayscale", [True, False], ids=["gray", "rgb"])
def test_rendered_cells_are_bit_equal(grayscale):
    cfg = config.load_config(DEMO / "config.json")
    mine = renderer.VisualTextRenderer.from_config(cfg)
    ref = jrenderer.VisualTextRenderer.from_config(jload_config(str(DEMO / "config.json")))
    for text in TEXTS:
        for rates in ([1.0] * len(text), [0.5 + 0.4 * i for i in range(len(text))]):
            a = mine.draw_with_width_rates(text, rates, cell_width=34, grayscale=grayscale)
            b = ref.draw_with_width_rates(text, rates, cell_width=34, grayscale=grayscale)
            assert a.dtype == b.dtype and np.array_equal(a, b), (text, rates)


def test_corpus_strips_and_saved_files_are_bit_equal(tmp_path):
    for stretching in (True, False):
        mine = renderer.VisualTextRenderer(fontsize=24, stretching=stretching, chars_per_sec=3.5)
        ref = jrenderer.VisualTextRenderer(fontsize=24, stretching=stretching, chars_per_sec=3.5)
        for i, text in enumerate(TEXTS):
            paths = {who: (tmp_path / f"{who}{i}{stretching}.png",
                           tmp_path / f"{who}{i}{stretching}.npy") for who in ("a", "b")}
            ca, wa = mine.draw(text, 1.3, *paths["a"])
            cb, wb = ref.draw(text, 1.3, *paths["b"])
            assert np.array_equal(np.asarray(ca), np.asarray(cb)) and np.array_equal(wa, wb)
            for pa, pb in zip(paths["a"], paths["b"]):
                assert pa.read_bytes() == pb.read_bytes()
    lens, n = np.array([30000, 41000, 52000]), np.array([3, 4, 6])
    assert renderer.compute_visualtext_info(lens, n) == jrenderer.compute_visualtext_info(lens, n)
    for chars in ("パンab", "ab", ""):
        assert renderer.glyph_source_for_chars("", 24, chars) == \
            jrenderer.glyph_source_for_chars("", 24, chars)


def test_symbol_maps_are_equal(tmp_path):
    pre = DEMO / "preprocessed"
    built = symbols.build_symbol_map(pre)
    assert built == jsymbols.build_symbol_map(pre)
    assert symbols.load_symbol_map(pre) == jsymbols.load_symbol_map(pre)
    assert symbols.load_symbol_map(tmp_path) is None
    for text in ("パンパン", "{パン}\nパン"):
        assert symbols.encode_text(text, built) == jsymbols.encode_text(text, built)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    symbols.save_symbol_map(tmp_path / "a", built)
    jsymbols.save_symbol_map(tmp_path / "b", built)
    assert (tmp_path / "a" / "symbols.json").read_bytes() == \
        (tmp_path / "b" / "symbols.json").read_bytes()


def test_wav_bytes_and_reading_are_equal(tmp_path):
    rng = np.random.default_rng(0)
    audio = np.concatenate([rng.uniform(-1.2, 1.2, 4000), [1.0, -1.0, 0.0]]).astype(np.float32)
    assert audio_io.wav_bytes(audio, 22050) == jaudio_io.wav_bytes(audio, 22050)
    audio_io.write_wav(tmp_path / "a.wav", audio, 48000)
    jaudio_io.write_wav(tmp_path / "b.wav", audio, 48000)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    # PCM through the stdlib, resampled 48 kHz -> 22.05 kHz
    np.testing.assert_array_equal(audio_io.load_audio(tmp_path / "a.wav"),
                                  jaudio_io.load_audio(tmp_path / "a.wav"))
    # IEEE float stereo through the RIFF parser
    data = np.stack([audio, -audio], 1).astype("<f4").tobytes()
    fmt = np.array([3, 2], "<u2").tobytes() + np.array([16000, 16000 * 8], "<u4").tobytes() + \
        np.array([8, 32], "<u2").tobytes()
    riff = b"WAVE" + b"fmt " + np.uint32(len(fmt)).tobytes() + fmt + b"data" + \
        np.uint32(len(data)).tobytes() + data
    (tmp_path / "f.wav").write_bytes(b"RIFF" + np.uint32(len(riff)).tobytes() + riff)
    got, want = audio_io.read_wav(tmp_path / "f.wav"), jaudio_io.read_wav(tmp_path / "f.wav")
    assert got[1] == want[1] == 16000 and np.array_equal(got[0], want[0])


def test_textgrids_and_alignment_are_equal(tmp_path):
    ivs = [labels.Interval(0.0, 0.1, ""), labels.Interval(0.1, 0.35, "パ"),
           labels.Interval(0.35, 0.52, "ン"), labels.Interval(0.52, 0.6, "sp"),
           labels.Interval(0.6, 0.91, "パ"), labels.Interval(0.91, 1.2, "")]
    labels.write_textgrid(ivs, tmp_path / "a.TextGrid")
    jlabels.write_textgrid([jlabels.Interval(i.start, i.end, i.text) for i in ivs],
                           tmp_path / "b.TextGrid")
    assert (tmp_path / "a.TextGrid").read_bytes() == (tmp_path / "b.TextGrid").read_bytes()
    got = labels.read_textgrid(tmp_path / "a.TextGrid")
    want = jlabels.read_textgrid(tmp_path / "a.TextGrid")
    assert [dataclasses.astuple(i) for i in got] == [dataclasses.astuple(i) for i in want]
    assert labels.SILENCE_LABELS == jlabels.SILENCE_LABELS
    for n_samples, margin in ((26460, 5), (30000, 2), (20000, 0)):
        a = alignment.align_tier(got, n_samples, 22050, 256, margin)
        b = jalignment.align_tier(want, n_samples, 22050, 256, margin)
        assert (a.characters, a.start, a.end) == (b.characters, b.start, b.end)
        assert np.array_equal(a.durations, b.durations) and a.durations.dtype == b.durations.dtype


def test_preprocess_host_helpers_are_equal():
    assert (preprocess.MAX_CHARS, preprocess.BATCH_CLIPS, preprocess.NUM_HOST_WORKERS,
            preprocess.MIN_CLIPS_FOR_PROCS) == (jpreprocess.MAX_CHARS, jpreprocess.BATCH_CLIPS,
                                                jpreprocess.NUM_HOST_WORKERS,
                                                jpreprocess.MIN_CLIPS_FOR_PROCS)
    assert preprocess._get_basename("ipaexg", 24, "c1 dr_um_001") == \
        jpreprocess._get_basename("ipaexg", 24, "c1 dr_um_001")
    for name in ("f_24pt_c1-drum-013-x", "f_24pt_c1-drum-014-x"):
        assert preprocess._is_traindata(name, (13, 33)) == jpreprocess._is_traindata(name, (13, 33))
    for text in ("パパパン", "パンパン", "ンパパパ", "アアアアイ", ""):
        assert preprocess.Preprocessor._consecutive_pos(text) == \
            jpreprocess.Preprocessor._consecutive_pos(text)


class _Synth:
    """What the server's request validation reads of a Synthesizer."""
    use_image = False
    symbol_map = {"パ": 1, "ン": 2}

    class metadata:
        audiotype_map = {"drum": 0, "bell": 1}


REQUESTS = [
    {"text": "パン", "audiotype": "drum"}, {"text": "", "audiotype": "drum"},
    {"text": "パ" * 65, "audiotype": 0}, {"text": "パ{ン}", "audiotype": 0},
    {"text": "パン", "audiotype": "piano"}, {"text": "パン", "audiotype": 2},
    {"text": "パン", "audiotype": True}, {"text": "パx", "audiotype": 1},
    {"text": "パン", "audiotype": 1, "width_rates": [1.0]},
    {"text": "パン", "audiotype": 1, "width_rates": [1.0, 9.0]},
    {"text": "パン", "audiotype": 1, "e_control": float("nan")},
    {"text": "パン", "audiotype": 1, "d_control": 10 ** 400}, "not a dict",
]


def test_server_limits_and_request_validation_are_equal():
    assert (serve.MAX_TEXT_LEN, serve.MAX_BODY_BYTES, serve.WIDTH_RATE_RANGE,
            serve.CONTROL_RANGE) == (jserve.MAX_TEXT_LEN, jserve.MAX_BODY_BYTES,
                                     jserve.WIDTH_RATE_RANGE, jserve.CONTROL_RANGE)
    mine = serve.BatchingServer.__new__(serve.BatchingServer)
    ref = jserve.BatchingServer.__new__(jserve.BatchingServer)
    for srv in (mine, ref):
        srv.synth, srv.max_text_len = _Synth(), jserve.MAX_TEXT_LEN
    for req in REQUESTS:
        assert (mine._validate(req) is None) == (ref._validate(req) is None), req
