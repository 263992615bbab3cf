"""Visual-onomatopoeia rendering: text -> stretched glyph strip (copy of
visual_onoma_to_wave_tpu/data/renderer.py).

* canvas width = ceil(chars_per_sec * wav_sec * fontsize) when stretching,
  fontsize * len(text) otherwise;
* per-character widths by fair integer allocation, (W + i) // n;
* each glyph drawn on a fontsize square, resized to its width, pasted in turn.

When the configured font file cannot be loaded, PIL's default font stands
in (the geometry depends only on the width allocation). A character the
active font has no glyph for is drawn as a deterministic stroke pattern
seeded by its code point, so glyph identity survives on a host without a CJK
font; `glyph_source_for_chars` reports which of the two a corpus got.
"""
from __future__ import annotations

import pathlib
from functools import lru_cache

import numpy as np
from PIL import Image, ImageDraw, ImageFont


@lru_cache(maxsize=8)
def _load_font(font_path: str, fontsize: int):
    try:
        return ImageFont.truetype(font_path, fontsize)
    except Exception:
        try:
            return ImageFont.load_default(size=fontsize)
        except TypeError:  # older PIL without the size keyword
            return ImageFont.load_default()


def _glyph_mask(font, ch: str, size: int) -> np.ndarray:
    im = Image.new("L", (size, size), 0)
    ImageDraw.Draw(im).text((0, 0), ch, fill=255, font=font)
    return np.asarray(im)


@lru_cache(maxsize=64)
def _font_cmap(font_path: str):
    """Code points of a TrueType/OpenType font file, or None when the path
    is not a parseable font (then the bitmap comparison decides)."""
    try:
        from fontTools.ttLib import TTFont

        tt = TTFont(font_path, fontNumber=0, lazy=True)
        try:
            return frozenset(tt.getBestCmap())
        finally:
            tt.close()
    except Exception:
        return None


@lru_cache(maxsize=4096)
def _has_glyph(font_path: str, fontsize: int, ch: str) -> bool:
    """True when the active font has a real glyph for ch: its character map
    decides, or, for a path that is no font file, a comparison with the
    render of an unmapped private-use code point."""
    cmap = _font_cmap(font_path)
    if cmap is not None:
        return ord(ch) in cmap
    font = _load_font(font_path, fontsize)
    return not np.array_equal(_glyph_mask(font, ch, fontsize),
                              _glyph_mask(font, "\ue000", fontsize))


def glyph_source_for_chars(font_path: str, fontsize: int, chars) -> str:
    """'font' (every character has a glyph), 'procedural' (none has) or 'mixed'."""
    chars = [c for c in dict.fromkeys(chars) if not c.isspace()]
    if not chars:
        return "font"
    n = sum(_has_glyph(str(font_path), int(fontsize), c) for c in chars)
    return "font" if n == len(chars) else ("procedural" if n == 0 else "mixed")


def _draw_procedural_glyph(draw: "ImageDraw.ImageDraw", ch: str, fontsize: int, fg) -> None:
    """The stroke pattern of a character without a glyph, seeded by ord(ch)."""
    rng = np.random.default_rng(ord(ch))
    s = fontsize
    pad = max(2, s // 8)
    w = max(1, s // 10)
    pts = rng.integers(pad, max(pad + 1, s - pad), (4, 2))
    for i in range(3):
        draw.line([tuple(pts[i]), tuple(pts[i + 1])], fill=fg, width=w)
    cx, cy = rng.integers(pad, max(pad + 1, s - pad), 2)
    r = int(rng.integers(2, max(3, s // 4)))
    draw.ellipse([cx - r, cy - r, cx + r, cy + r], outline=fg, width=max(1, s // 12))


def _draw_char_cell(bg, fg, font_path: str, fontsize: int, ch: str):
    """A fontsize-square RGB cell with ch's glyph (font or procedural)."""
    cell = Image.new("RGB", (fontsize, fontsize), bg)
    d = ImageDraw.Draw(cell)
    if _has_glyph(font_path, fontsize, ch):
        d.text((0, 0), ch, fill=fg, font=_load_font(font_path, fontsize))
    else:
        _draw_procedural_glyph(d, ch, fontsize, fg)
    return cell


def allocate_character_widths(text_len: int, canvas_width: int) -> np.ndarray:
    """Fair integer split of canvas_width into text_len cells."""
    return np.array([(canvas_width + i) // text_len for i in range(text_len)], dtype=np.int32)


class VisualTextRenderer:
    """Renders onomatopoeia text to a width-stretched strip."""

    def __init__(self, font_path: str = "", fontsize: int = 24, stretching: bool = True,
                 background_color: tuple[int, int, int] = (255, 255, 255),
                 text_color: tuple[int, int, int] = (0, 0, 0), chars_per_sec: float = 4.0):
        self.font_path = str(font_path)
        self.fontsize = fontsize
        self.stretching = stretching
        self.bg = tuple(background_color)
        self.fg = tuple(text_color)
        self.chars_per_sec = chars_per_sec

    @classmethod
    def from_config(cls, config, chars_per_sec: float = 4.0) -> "VisualTextRenderer":
        vt = config.visual_text
        return cls(font_path=config.path.font, fontsize=vt.fontsize,
                   stretching=vt.image_stretching, background_color=vt.background_color,
                   text_color=vt.text_color, chars_per_sec=chars_per_sec)

    def canvas_width(self, text: str, wav_sec: float | None) -> int:
        if self.stretching:
            if wav_sec is None:
                raise ValueError("stretching mode requires wav_sec")
            return int(np.ceil(self.chars_per_sec * wav_sec * self.fontsize))
        return self.fontsize * len(text)

    def draw(self, text: str, wav_sec: float | None = None,
             save_image: str | pathlib.Path | None = None,
             save_width: str | pathlib.Path | None = None) -> tuple[Image.Image, np.ndarray]:
        """The corpus strip of `text` (pass 2 of preprocessing) and its cell widths."""
        width = self.canvas_width(text, wav_sec)
        canvas = Image.new("RGB", (width, self.fontsize), self.bg)
        char_widths = allocate_character_widths(len(text), width)
        x = 0
        for ch, w in zip(text, char_widths):
            cell = _draw_char_cell(self.bg, self.fg, self.font_path, self.fontsize, ch)
            if self.stretching:
                cell = cell.resize((int(w), self.fontsize))
            canvas.paste(cell, (x, 0))
            x += int(w)
        if save_image is not None:
            canvas.save(save_image, compress_level=1)
        if save_width is not None:
            np.save(save_width, char_widths)
        return canvas, char_widths

    def draw_with_width_rates(self, text: str, width_rates: list[float], cell_width: int = 102,
                              grayscale: bool = True) -> np.ndarray:
        """Serving's rendering: a len(text) * cell_width canvas, glyph i
        resized to fontsize * width_rates[i] wide and centred in its cell.
        Returns (fontsize, len(text) * cell_width) uint8 (or RGB)."""
        canvas = Image.new("RGB", (cell_width * len(text), self.fontsize), self.bg)
        for i, (ch, rate) in enumerate(zip(text, width_rates)):
            cell = _draw_char_cell(self.bg, self.fg, self.font_path, self.fontsize, ch)
            w = max(1, int(round(self.fontsize * rate)))
            cell = cell.resize((w, self.fontsize))
            off = i * cell_width + (cell_width - w) // 2 + (cell_width - w) % 2
            canvas.paste(cell, (off, 0))
        if grayscale:
            return np.asarray(canvas.convert("L"), dtype=np.uint8)
        return np.asarray(canvas, dtype=np.uint8)


def compute_visualtext_info(wav_lens: np.ndarray, text_lens: np.ndarray,
                            sampling_rate: int = 22050,
                            fontsize: int = 24) -> tuple[float, float, float]:
    """Per class (chars_per_sec mean, max character width, min character width)."""
    wav_sec = wav_lens / sampling_rate
    cps = float(np.mean(text_lens / wav_sec))
    canvas_w = np.ceil(cps * wav_sec * fontsize).astype(np.int64)
    return (cps, float(np.max(np.ceil(canvas_w / text_lens))),
            float(np.min(np.ceil(canvas_w / text_lens))))
