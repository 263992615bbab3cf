"""The trainer's profiler trace and sample figure, and `utils/plotting.py`, on the CPU.

- `Trainer(profile_dir=, profile_steps=(1, 3))` writes a Chrome trace of
  steps 2-3 that holds events, closed when training ends;
- the sample synthesis writes `<result>/Val/<step>_<name>.png`: the
  reference's mel + energy figure (the input strip, two panels);
- `expand_char_values` equals the JAX package's;
- the figure's layout: the panel count and size, the dotted break pixels at
  their frames' columns, the energy contour within its panel at the rows
  its values and `energy_ylim` give, the input strip's grey levels; the
  plain panels of the demo server unchanged.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

from test_torch_dataset import preprocessed_corpus
from visual_onoma_to_wave_tpu.utils.plotting import expand_char_values as jexpand
from visual_onoma_to_wave_tpu_torch.config import load_config
from visual_onoma_to_wave_tpu_torch.utils import plotting

SMALL = {"transformer": {"encoder_layer": 1, "decoder_layer": 1, "encoder_hidden": 32,
                         "decoder_hidden": 32, "conv_filter_size": 64,
                         "conv_kernel_size": [3, 1]},
         "visual_feature_extractor": {"layer_num": 2}, "variance_predictor": {"filter_size": 32},
         "max_seq_len": 128, "postnet_channels": 32}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A trainer run of 3 steps with a profile window and a sample at step 3."""
    from visual_onoma_to_wave_tpu_torch.training.trainer import Trainer

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("extras")
    path = pathlib.Path(preprocessed_corpus(root, n_per_class=6, batch_size=4))
    cfg = json.loads(path.read_text())
    cfg["model"] = SMALL
    cfg["train"]["max_mel_len"] = 256
    cfg["train"]["step"].update(synth_step=3)
    path.write_text(json.dumps(cfg))
    config = load_config(path)
    trainer = Trainer(config, device="cpu", loader_workers=0,
                      profile_dir=str(root / "profile"), profile_steps=(1, 3))
    trainer.train(max_steps=3)
    torch.set_num_threads(threads)
    return trainer, root


def test_profile_dir_writes_a_trace_of_the_window(trained):
    trainer, root = trained
    traces = sorted((root / "profile").iterdir())
    assert traces == [trainer.profile_trace]
    assert trainer.profile_trace.name == "trace_p0_steps1-3.json"
    events = json.loads(trainer.profile_trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert len(events) > 100 and any(n.startswith("aten::") for n in names)


def test_sample_figure_is_written(trained):
    from PIL import Image

    trainer, _ = trained
    pngs = sorted((trainer.result_dir / "Val").glob("3_*.png"))
    assert len(pngs) == 1
    name = pngs[0].stem[len("3_"):]
    assert (trainer.result_dir / "Val" / f"3_{name}_synthesis.npy").exists()
    with Image.open(pngs[0]) as im:
        assert im.size == (plotting.FIG_WIDTH, plotting.STRIP_HEIGHT + 2 * plotting.PANEL_HEIGHT)


def test_expand_char_values_equals_jax():
    rng = np.random.default_rng(0)
    values = rng.normal(size=7).astype(np.float32)
    durations = rng.integers(0, 6, 7)
    for max_len in (None, 5, 100):
        got = plotting.expand_char_values(values, durations, max_len)
        want = jexpand(values, durations, max_len)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_figure_layout():
    rng = np.random.default_rng(1)
    T, spec_h = 60, plotting.PANEL_HEIGHT - plotting.TITLE_HEIGHT
    mel = rng.normal(-5, 1, (T, 80))
    durations = np.array([10, 25, 15, 10])
    energy = plotting.expand_char_values(np.array([-1.0, 0.5, 1.5, 0.0]), durations)
    breaks = np.insert(np.cumsum(durations), 0, 0)
    strip = np.tile(np.linspace(0, 255, 40), (12, 1)).astype(np.uint8)
    fig = plotting.plot_mel([(mel, "a"), (mel[:40], "b")], energies=[energy, energy[:40]],
                            char_breaks=[breaks, breaks], energy_ylim=(-2.0, 2.0),
                            input_image=strip)
    img = np.asarray(fig)
    assert img.shape == (plotting.STRIP_HEIGHT + 2 * plotting.PANEL_HEIGHT, plotting.FIG_WIDTH, 3)
    # the input strip: grey, dark on the left, light on the right
    top = img[:plotting.STRIP_HEIGHT]
    assert (top[..., 0] == top[..., 1]).all() and top[:, 0].max() < top[:, -1].min()
    plain = np.asarray(plotting.plot_mel([(mel, "a"), (mel[:40], "b")]))
    violet = np.array(plotting.ENERGY_RGB)
    for i, n in enumerate((T, 40)):
        y0 = plotting.STRIP_HEIGHT + i * plotting.PANEL_HEIGHT + plotting.TITLE_HEIGHT
        panel = img[y0:y0 + spec_h].astype(int)
        base = plain[i * plotting.PANEL_HEIGHT + plotting.TITLE_HEIGHT:
                     (i + 1) * plotting.PANEL_HEIGHT].astype(int)
        # the breaks: every 4th row of their columns blended halfway to violet
        for b in breaks:
            x = plotting.frame_x(b, n)
            if x >= plotting.FIG_WIDTH:
                continue
            rows = np.arange(0, spec_h, 4)
            blended = np.round(base[rows, x] * 0.5 + violet * 0.5)
            line = np.all(panel[rows, x] == violet, axis=-1)
            assert np.array_equal(panel[rows, x][~line], blended[~line]), (i, b)
        # the contour: violet pixels, at the rows of the energy values over their columns
        ys, xs = np.nonzero(np.all(panel == violet, axis=-1))
        assert xs.min() == 0 and xs.max() == plotting.FIG_WIDTH - 1
        for t, v in ((0, -1.0), (20, 0.5), (45, 1.5)):
            if t < n:
                x = plotting.frame_x(t, n)
                assert plotting.energy_y(v, (-2.0, 2.0), 0, spec_h) in ys[xs == x], (i, t)
        assert ys.min() >= plotting.energy_y(1.5, (-2.0, 2.0), 0, spec_h)
        assert ys.max() <= plotting.energy_y(-1.0, (-2.0, 2.0), 0, spec_h)
    # the demo server's figure is the plain panels, unchanged by the new options
    assert plain.shape == (2 * plotting.PANEL_HEIGHT, plotting.FIG_WIDTH, 3)
