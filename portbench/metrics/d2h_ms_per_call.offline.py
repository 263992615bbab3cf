"""Host milliseconds a call of `Synthesizer.synthesize_batch` spends in the
program's `synth.d2h` span (every output copied to the host), averaged
over the window's calls (`synth.batch` spans). In the traced run the
benchmark synchronises after the fused call, so this is the copies alone.
Read from the port's span recorder (`visual_onoma_to_wave_tpu_torch.tracing`,
found in `sys.modules`); None where the program records no such span."""
import sys

NAME = "d2h_ms_per_call.offline"
UNIT = "ms"
LAYER = "host synthesis (synthesis.py Synthesizer)"
SOURCE = "program_span"
MOVES = "audio_x_realtime"


def read(ctx):
    rec = sys.modules.get("visual_onoma_to_wave_tpu_torch.tracing")
    spans = rec.spans() if rec is not None else []
    calls = sum(1 for s in spans if s.name == "synth.batch")
    d2h = [s.end - s.start for s in spans if s.name == "synth.d2h"]
    if not calls or not d2h:
        return None
    return sum(d2h) / 1e6 / calls
