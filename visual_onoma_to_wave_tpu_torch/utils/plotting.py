"""Mel figures drawn with PIL and numpy (port of
visual_onoma_to_wave_tpu/utils/plotting.py, which draws with matplotlib).

`plot_mel` stacks one panel per mel, each the spectrogram with low bins at
the bottom, coloured by viridis over the mel's own range (matplotlib's
`imshow` default), its title above it. The figure has the reference
figure's pixel size at 100 dpi: `FIG_WIDTH` wide, `PANEL_HEIGHT` per mel
panel, and `STRIP_HEIGHT` more on top for the visual-text input strip when
one is given. As in the reference's mel + energy figure (the trainer's
sample), a panel may carry its frame-level energy contour, in violet, on
an axis spanning frames 0 to T - 1 across the width and `energy_ylim` (or
the contour's own range) up the spectrogram's height, and dotted violet
lines at its character breaks. `png_bytes` encodes the figure; the demo
server sends its plain panels as the mel figure. Axes, ticks and labels
are not drawn. `expand_char_values` repeats character values into frames.
"""
from __future__ import annotations

import io

import numpy as np

FIG_WIDTH = 800       # 8 in at 100 dpi
PANEL_HEIGHT = 300    # 3 in per mel panel
STRIP_HEIGHT = 60     # 0.6 in: the input strip's share of the reference's figure
TITLE_HEIGHT = 14
ENERGY_RGB = (238, 130, 238)     # matplotlib's "violet"

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


def frame_x(frame: float, n_frames: int, width: int = FIG_WIDTH) -> int:
    """The pixel column of a frame on the energy axis (frames 0 .. T - 1 span the width)."""
    return int(round(float(frame) * (width - 1) / max(n_frames - 1, 1)))


def energy_y(value: float, ylim: tuple[float, float], top: int, height: int) -> int:
    """The pixel row of an energy value: ylim[0] at the spectrogram's bottom
    row, ylim[1] at its top row (clipped to the panel)."""
    lo, hi = float(ylim[0]), float(ylim[1])
    frac = (float(value) - lo) / (hi - lo) if hi > lo else 0.5
    return top + int(round((1.0 - min(max(frac, 0.0), 1.0)) * (height - 1)))


def _blend(img: np.ndarray, ys, x: int, rgb, alpha: float) -> None:
    img[ys, x] = np.round(img[ys, x] * (1.0 - alpha) + np.asarray(rgb) * alpha).astype(np.uint8)


def plot_mel(mels_and_titles, energies=None, char_breaks=None, energy_ylim=None,
             input_image=None):
    """mels_and_titles: list of (mel (T, n_mels), title). Returns an RGB
    `PIL.Image` of FIG_WIDTH x (PANEL_HEIGHT per panel, plus STRIP_HEIGHT
    on top with `input_image`).

    energies: optional per-panel frame-level energy contour (or None entries);
    char_breaks: optional per-panel frame indices of character boundaries,
        drawn where the panel has an energy contour (as the reference);
    energy_ylim: (min, max) of the energy axis (the trainer passes the
        corpus's energy min and max, so panels compare across steps);
    input_image: optional (H, W) grayscale visual-text strip above the panels."""
    from PIL import Image, ImageDraw

    extra = STRIP_HEIGHT if input_image is not None else 0
    fig = Image.new("RGB", (FIG_WIDTH, extra + PANEL_HEIGHT * len(mels_and_titles)), "white")
    if input_image is not None:
        strip = np.asarray(input_image, np.float64)
        lo, hi = float(strip.min()), float(strip.max())
        gray = np.round((strip - lo) / (hi - lo) * 255.0) if hi > lo else np.zeros_like(strip)
        rows = (np.arange(STRIP_HEIGHT) * strip.shape[0]) // STRIP_HEIGHT
        cols = (np.arange(FIG_WIDTH) * strip.shape[1]) // FIG_WIDTH
        fig.paste(Image.fromarray(gray.astype(np.uint8)[rows][:, cols]).convert("RGB"), (0, 0))
    draw = ImageDraw.Draw(fig)
    spec_h = PANEL_HEIGHT - TITLE_HEIGHT
    for i, (mel, title) in enumerate(mels_and_titles):
        y0 = extra + i * PANEL_HEIGHT
        draw.text((4, y0 + 1), str(title), fill="black")
        panel = _spectrogram(mel, FIG_WIDTH, spec_h)
        energy = energies[i] if energies is not None else None
        if energy is not None:
            energy = np.asarray(energy, np.float64)
            n_frames = max(int(np.asarray(mel).shape[0]), 1)
            ylim = energy_ylim if energy_ylim is not None else (energy.min(), energy.max())
            breaks = char_breaks[i] if char_breaks is not None else None
            for b in (np.asarray(breaks) if breaks is not None else ()):
                x = frame_x(b, n_frames)
                if 0 <= x < FIG_WIDTH:
                    _blend(panel, np.arange(0, spec_h, 4), x, ENERGY_RGB, 0.5)   # dotted
            line = Image.fromarray(panel)
            pts = [(frame_x(t, n_frames), energy_y(v, ylim, 0, spec_h))
                   for t, v in enumerate(energy)]
            if len(pts) > 1:
                ImageDraw.Draw(line).line(pts, fill=ENERGY_RGB, width=1)
            elif pts:
                line.putpixel(pts[0], ENERGY_RGB)
            panel = np.asarray(line)
        fig.paste(Image.fromarray(panel), (0, y0 + TITLE_HEIGHT))
    return fig


def expand_char_values(values: np.ndarray, durations: np.ndarray,
                       max_len: int | None = None) -> np.ndarray:
    """Character-level values -> frame-level contour, each value repeated
    durations[i] times (the reference's `expand`)."""
    out = np.repeat(np.asarray(values), np.asarray(durations).astype(int))
    if max_len is not None:
        out = out[:max_len]
    return out


def png_bytes(image) -> bytes:
    """A PIL image encoded as PNG."""
    buf = io.BytesIO()
    image.save(buf, format="PNG")
    return buf.getvalue()

