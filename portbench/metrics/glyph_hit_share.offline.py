"""Share of the renderer's resized-cell lookups in the window that found the
cell already built, in %: the `synth.glyph_hits` counts of the window's spans
over `synth.glyph_hits` + `synth.glyph_misses` (a miss is a cell resized and
converted anew), over its calls of `Synthesizer.synthesize_batch`
(`synth.batch` spans). A count: it repeats exactly for a seed in one process.
Read from the port's span recorder (`visual_onoma_to_wave_tpu_torch.tracing`,
found in `sys.modules`); None where the program records no such count."""
import sys

NAME = "glyph_hit_share.offline"
UNIT = "%"
LAYER = "renderer (data/renderer.py, under Synthesizer)"
SOURCE = "program_counter"
MOVES = "audio_x_realtime"


def read(ctx):
    rec = sys.modules.get("visual_onoma_to_wave_tpu_torch.tracing")
    spans = rec.spans() if rec is not None else []
    if not any(s.name == "synth.batch" for s in spans):
        return None
    hits = misses = 0
    for s in spans:
        if s.counts:
            hits += s.counts.get("synth.glyph_hits", 0)
            misses += s.counts.get("synth.glyph_misses", 0)
    if not hits + misses:
        return None
    return 100.0 * hits / (hits + misses)
