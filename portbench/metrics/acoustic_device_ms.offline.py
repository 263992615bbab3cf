"""Device milliseconds a call of the kernels launched under a profiler
range around the acoustic forward (`VTTS.forward`), averaged over the window's calls."""
NAME = "acoustic_device_ms.offline"
UNIT = "ms"
LAYER = "acoustic model (models/vtts.py)"
SOURCE = "device_trace"
MOVES = "audio_x_realtime"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["op_calls"].get("acoustic"):
        return None
    return 1e3 * tr["device_s"]["acoustic"] / tr["op_calls"]["acoustic"]
