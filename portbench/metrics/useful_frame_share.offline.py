"""Share of the mel frames the vocoder was given that are a request's own:
100 x the `synth.frames` counts (each request's mel_len) over the
`synth.frames_vocoded` counts (the padded rows x the mel buffer's frames)
of the window's spans. Read from the port's span recorder
(`visual_onoma_to_wave_tpu_torch.tracing`, found in `sys.modules`); None
where the program records no such count."""
import sys

NAME = "useful_frame_share.offline"
UNIT = "%"
LAYER = "fused step (synthesis.py make_fused_infer)"
SOURCE = "program_span"
MOVES = "audio_x_realtime"


def read(ctx):
    rec = sys.modules.get("visual_onoma_to_wave_tpu_torch.tracing")
    spans = rec.spans() if rec is not None else []

    def total(name):
        return sum(s.counts.get(name, 0) for s in spans if s.counts)

    vocoded = total("synth.frames_vocoded")
    if not vocoded:
        return None
    return 100.0 * total("synth.frames") / vocoded
