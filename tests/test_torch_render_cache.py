"""The renderer's memoised glyph cells (`data/renderer.py`) and the counts
`Synthesizer` makes of them.

`draw_with_width_rates` composes each strip from memoised resized cells in
numpy; here it is held byte for byte to the loop it replaced (each cell drawn
anew, resized, pasted onto a PIL canvas, the canvas converted), cold and
warm, over every katakana the benchmark writes in at every width from 1 to
20 pixels past the cell (cells that overlap and overhang both edges), in
grey and RGB, with the fallback font's glyphs, procedural glyphs and a
non-grey colour pair. `draw` is held to the same loop with a cold cache.
"""
import numpy as np
import pytest
from PIL import Image

from test_torch_serve import port_synthesizer
from test_trainer_synthesis import tiny_env  # noqa: F401 (fixture reuse)
from test_torch_tracing import session
from visual_onoma_to_wave_tpu_torch import tracing
from visual_onoma_to_wave_tpu_torch.data import renderer
from visual_onoma_to_wave_tpu_torch.data.renderer import VisualTextRenderer, _has_glyph

KATAKANA = "".join(chr(c) for c in range(0x30A2, 0x30F4))   # the benchmark's alphabet
LATIN = "AbgQ7"                                              # glyphs of PIL's default font
CELL = 34                                                    # narrow: neighbours overlap
COLOURS = {"grey": ((255, 255, 255), (0, 0, 0)), "colour": ((30, 90, 160), (250, 200, 10))}


def clear_caches() -> None:
    renderer._draw_char_cell.cache_clear()
    renderer._sized_cell.cache_clear()


def pasted(r: VisualTextRenderer, text, rates, cell_width: int, grayscale: bool) -> np.ndarray:
    """The strip as each cell drawn anew and pasted onto a PIL canvas."""
    draw = renderer._draw_char_cell.__wrapped__
    canvas = Image.new("RGB", (cell_width * len(text), r.fontsize), r.bg)
    for i, (ch, rate) in enumerate(zip(text, rates)):
        w = max(1, int(round(r.fontsize * rate)))
        cell = draw(r.bg, r.fg, r.font_path, r.fontsize, ch).resize((w, r.fontsize))
        canvas.paste(cell, (i * cell_width + (cell_width - w) // 2 + (cell_width - w) % 2, 0))
    return np.asarray(canvas.convert("L") if grayscale else canvas, dtype=np.uint8)


def test_the_alphabets_take_both_glyph_kinds():
    assert not any(_has_glyph("", 24, c) for c in KATAKANA)   # procedural on the fallback font
    assert all(_has_glyph("", 24, c) for c in LATIN)


@pytest.mark.parametrize("grayscale", [True, False], ids=["gray", "rgb"])
@pytest.mark.parametrize("colours", sorted(COLOURS))
@pytest.mark.parametrize("alphabet", ["katakana", "latin"])
@pytest.mark.parametrize("cell_width", [CELL, 102], ids=["narrow", "served"])
def test_strip_is_byte_equal_to_pasting_each_cell(grayscale, colours, alphabet, cell_width):
    bg, fg = COLOURS[colours]
    r = VisualTextRenderer(fontsize=24, background_color=bg, text_color=fg)
    chars = KATAKANA if alphabet == "katakana" else LATIN
    clear_caches()
    for w in range(1, cell_width + 21):
        rates = [w / 24] * len(chars)
        want = pasted(r, chars, rates, cell_width, grayscale)
        for _ in ("cold", "warm"):
            got = r.draw_with_width_rates(chars, rates, cell_width=cell_width, grayscale=grayscale)
            assert got.dtype == np.uint8 and got.shape == want.shape
            assert np.array_equal(got, want), w
    # mixed widths in one strip, each cell's neighbours wider or narrower
    rng = np.random.default_rng(7)
    for _ in range(20):
        text = "".join(rng.choice(list(chars), 6))
        rates = list(rng.uniform(1 / 24, (cell_width + 20) / 24, 6))
        want = pasted(r, text, rates, cell_width, grayscale)
        assert np.array_equal(r.draw_with_width_rates(text, rates, cell_width, grayscale), want)


def test_strips_are_fresh_and_cached_cells_read_only():
    r = VisualTextRenderer(fontsize=24)
    strip = r.draw_with_width_rates("パン", [1.0, 0.5], cell_width=CELL)
    assert strip.flags.writeable
    strip[:] = 7                                  # the caller's to keep: no cache shares it
    again = r.draw_with_width_rates("パン", [1.0, 0.5], cell_width=CELL)
    assert np.array_equal(again, pasted(r, "パン", [1.0, 0.5], CELL, True))
    for grayscale in (True, False):
        cell = renderer._sized_cell(r.bg, r.fg, r.font_path, 24, "パ", 12, grayscale)
        assert cell.shape == ((24, 12) if grayscale else (24, 12, 3))
        assert not cell.flags.writeable
        with pytest.raises(ValueError):
            cell[0, 0] = 0


@pytest.mark.parametrize("stretching", [True, False], ids=["stretched", "square"])
def test_corpus_strip_is_byte_equal_with_a_cold_cache(stretching):
    r = VisualTextRenderer(fontsize=24, stretching=stretching, chars_per_sec=3.5)
    draw = renderer._draw_char_cell.__wrapped__
    for text in ("パンパン", "ドA", KATAKANA[:12]):
        clear_caches()
        first, widths = r.draw(text, 1.3)
        second, _ = r.draw(text, 1.3)
        canvas = Image.new("RGB", first.size, r.bg)
        x = 0
        for ch, w in zip(text, widths):
            cell = draw(r.bg, r.fg, r.font_path, 24, ch)
            canvas.paste(cell.resize((int(w), 24)) if stretching else cell, (x, 0))
            x += int(w)
        assert np.array_equal(np.asarray(first), np.asarray(canvas))
        assert np.array_equal(np.asarray(second), np.asarray(canvas))


def test_float_cells_round_trip_every_grey_level():
    """The request's image was once rebuilt from its float cells; the
    renderer's strip is those bytes for every level."""
    levels = np.arange(256, dtype=np.uint8)
    assert np.array_equal((levels.astype(np.float32) / 255.0 * 255).astype(np.uint8), levels)


@pytest.fixture(scope="module")
def synth(tiny_env):  # noqa: F811
    return port_synthesizer(tiny_env)


def test_cells_written_in_place_equal_the_returned_cells(synth):
    text, rates = "パンカ", [1.0, 0.4, 3.9]
    cells = synth._render_cells(text, rates)
    buf = np.ones((4,) + cells.shape[1:], np.float32)
    strip = synth._render_cells(text, rates, out=buf[:3])
    assert cells.dtype == buf.dtype == np.float32
    assert np.array_equal(buf[:3], cells) and np.all(buf[3] == 1)
    assert strip.dtype == np.uint8
    assert np.array_equal(strip, synth.renderer.draw_with_width_rates(text, rates, synth.cell_width))


def glyph_counts() -> tuple[int, int]:
    spans = tracing.spans()
    return tuple(sum(s.counts.get(name, 0) for s in spans if s.counts)
                 for name in ("synth.glyph_hits", "synth.glyph_misses"))


def test_hits_and_misses_count_every_glyph_and_a_repeat_is_all_hits(synth):
    texts = ["パン", "ドンドン", "カ"]
    rates = [[1.0, 0.5], [1.0, 0.5, 1.0, 2.0], None]
    clear_caches()
    before = tracing.counters()
    with session():
        first = synth.synthesize_batch(texts, ["drum"] * 3, width_rates=rates)
    hits, misses = glyph_counts()
    # lookups (char, width): パ24 ン12 | ド24 ン12 ド24 ン48 | カ24: 5 cells to build
    assert (hits, misses) == (2, 5) and hits + misses == sum(map(len, texts))
    after = tracing.counters()
    assert after["synth.glyph_hits"] - before.get("synth.glyph_hits", 0) == 2
    assert after["synth.glyph_misses"] - before.get("synth.glyph_misses", 0) == 5
    with session():
        again = synth.synthesize_batch(texts, ["drum"] * 3, width_rates=rates)
    assert glyph_counts() == (7, 0)
    for a, b, t, r in zip(first, again, texts, rates):
        want = pasted(synth.renderer, t, r or [1.0] * len(t), synth.cell_width, True)
        assert np.array_equal(a.image, want) and np.array_equal(b.image, want)
