"""Host milliseconds a call of `Synthesizer.synthesize_batch` spends
outside its fused device call (rendering, padding, copies, slicing): the
span around the batch call minus the span around the fused call, the
latter synchronised with the device, averaged over the window's calls."""
NAME = "host_ms_per_call.offline"
UNIT = "ms"
LAYER = "host synthesis (synthesis.py Synthesizer)"
SOURCE = "program_span"
MOVES = "audio_x_realtime"


def read(ctx):
    calls = [c for c in ctx.get("calls", ()) if "batch_s" in c]
    if not calls:
        return None
    return 1e3 * sum(c["batch_s"] - c["fused_s"] for c in calls) / len(calls)
