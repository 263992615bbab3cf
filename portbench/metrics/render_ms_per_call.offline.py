"""Host milliseconds a call of `Synthesizer.synthesize_batch` spends in the
program's `synth.render` span (every request's encoding, glyph rendering
and uint8 image), averaged over the window's calls (`synth.batch` spans).
Read from the port's span recorder (`visual_onoma_to_wave_tpu_torch.tracing`,
found in `sys.modules`); None where the program records no such span."""
import sys

NAME = "render_ms_per_call.offline"
UNIT = "ms"
LAYER = "renderer (data/renderer.py, under Synthesizer)"
SOURCE = "program_span"
MOVES = "audio_x_realtime"


def read(ctx):
    rec = sys.modules.get("visual_onoma_to_wave_tpu_torch.tracing")
    spans = rec.spans() if rec is not None else []
    calls = sum(1 for s in spans if s.name == "synth.batch")
    render = [s.end - s.start for s in spans if s.name == "synth.render"]
    if not calls or not render:
        return None
    return sum(render) / 1e6 / calls
