"""Megabytes (1e6 bytes) copied from the device to the host a call of
`Synthesizer.synthesize_batch`: the `synth.d2h_bytes` counts (the nbytes of
every output copied) of the window's spans over its calls (`synth.batch`
spans). A count: it repeats exactly for a seed. Read from the port's span
recorder (`visual_onoma_to_wave_tpu_torch.tracing`, found in `sys.modules`);
None where the program records no such count."""
import sys

NAME = "d2h_mb_per_call.offline"
UNIT = "MB"
LAYER = "host synthesis (synthesis.py Synthesizer)"
SOURCE = "program_span"
MOVES = "audio_x_realtime"


def read(ctx):
    rec = sys.modules.get("visual_onoma_to_wave_tpu_torch.tracing")
    spans = rec.spans() if rec is not None else []
    calls = sum(1 for s in spans if s.name == "synth.batch")
    counted = [s.counts["synth.d2h_bytes"] for s in spans
               if s.counts and "synth.d2h_bytes" in s.counts]
    if not calls or not counted:
        return None
    return sum(counted) / calls / 1e6
