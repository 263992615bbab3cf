"""Mel figures drawn with PIL and numpy (port of
visual_onoma_to_wave_tpu/utils/plotting.py, which draws with matplotlib).

`plot_mel` stacks one panel per mel, each the spectrogram with low bins at
the bottom, coloured by viridis over the mel's own range (matplotlib's
`imshow` default), its title above it. The figure has the reference
figure's pixel size at 100 dpi: `FIG_WIDTH` wide, `PANEL_HEIGHT` per mel
panel. `png_bytes` encodes it; the demo server sends it as the mel figure.
Axes, ticks and labels are not drawn, nor the reference's energy contour,
character breaks and input strip, which only the trainer's figure uses.
"""
from __future__ import annotations

import io

import numpy as np

FIG_WIDTH = 800       # 8 in at 100 dpi
PANEL_HEIGHT = 300    # 3 in per mel panel
TITLE_HEIGHT = 14

# matplotlib's viridis at 0, 1/32, ..., 1; linear in between
_VIRIDIS = np.array([
    [0.267004, 0.004874, 0.329415], [0.277018, 0.050344, 0.375715],
    [0.282327, 0.094955, 0.417331], [0.282884, 0.135920, 0.453427],
    [0.278826, 0.175490, 0.483397], [0.270595, 0.214069, 0.507052],
    [0.258965, 0.251537, 0.524736], [0.244972, 0.287675, 0.537260],
    [0.229739, 0.322361, 0.545706], [0.214298, 0.355619, 0.551184],
    [0.199430, 0.387607, 0.554642], [0.185556, 0.418570, 0.556753],
    [0.172719, 0.448791, 0.557885], [0.160665, 0.478540, 0.558115],
    [0.149039, 0.508051, 0.557250], [0.137770, 0.537492, 0.554906],
    [0.127568, 0.566949, 0.550556], [0.120565, 0.596422, 0.543611],
    [0.120638, 0.625828, 0.533488], [0.132268, 0.655014, 0.519661],
    [0.157851, 0.683765, 0.501686], [0.196571, 0.711827, 0.479221],
    [0.246070, 0.738910, 0.452024], [0.304148, 0.764704, 0.419943],
    [0.369214, 0.788888, 0.382914], [0.440137, 0.811138, 0.340967],
    [0.515992, 0.831158, 0.294279], [0.595839, 0.848717, 0.243329],
    [0.678489, 0.863742, 0.189503], [0.762373, 0.876424, 0.137064],
    [0.845561, 0.887322, 0.099702], [0.926106, 0.897330, 0.104071],
    [0.993248, 0.906157, 0.143936]])


def viridis(x: np.ndarray) -> np.ndarray:
    """Values in [0, 1] -> uint8 RGB (..., 3)."""
    pos = np.clip(np.asarray(x, np.float64), 0.0, 1.0) * (len(_VIRIDIS) - 1)
    lo = np.minimum(pos.astype(int), len(_VIRIDIS) - 2)
    frac = (pos - lo)[..., None]
    rgb = _VIRIDIS[lo] * (1.0 - frac) + _VIRIDIS[lo + 1] * frac
    return np.round(rgb * 255.0).astype(np.uint8)


def _spectrogram(mel: np.ndarray, width: int, height: int) -> np.ndarray:
    """(T, n_mels) -> (height, width, 3) uint8: bins upwards, frames to the
    right, nearest-neighbour scaling (`interpolation="none"`)."""
    mel = np.asarray(mel, np.float64)
    lo, hi = float(mel.min()), float(mel.max())
    norm = (mel - lo) / (hi - lo) if hi > lo else np.zeros_like(mel)
    img = viridis(norm.T[::-1])                              # (n_mels, T, 3)
    rows = (np.arange(height) * img.shape[0]) // height
    cols = (np.arange(width) * img.shape[1]) // width
    return img[rows][:, cols]


def plot_mel(mels_and_titles):
    """mels_and_titles: list of (mel (T, n_mels), title). Returns an RGB
    `PIL.Image` of FIG_WIDTH x (PANEL_HEIGHT per panel)."""
    from PIL import Image, ImageDraw

    fig = Image.new("RGB", (FIG_WIDTH, PANEL_HEIGHT * len(mels_and_titles)), "white")
    draw = ImageDraw.Draw(fig)
    spec_h = PANEL_HEIGHT - TITLE_HEIGHT
    for i, (mel, title) in enumerate(mels_and_titles):
        y0 = i * PANEL_HEIGHT
        draw.text((4, y0 + 1), str(title), fill="black")
        fig.paste(Image.fromarray(_spectrogram(mel, FIG_WIDTH, spec_h)), (0, y0 + TITLE_HEIGHT))
    return fig


def png_bytes(image) -> bytes:
    """A PIL image encoded as PNG."""
    buf = io.BytesIO()
    image.save(buf, format="PNG")
    return buf.getvalue()

