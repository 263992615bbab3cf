"""Device milliseconds a call of the kernels launched under a profiler
range around the vocoder's forward, averaged over the window's calls."""
NAME = "vocoder_device_ms.offline"
UNIT = "ms"
LAYER = "vocoder (models/hifigan.py, models/vocos.py)"
SOURCE = "device_trace"
MOVES = "audio_x_realtime"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["op_calls"].get("vocoder"):
        return None
    return 1e3 * tr["device_s"]["vocoder"] / tr["op_calls"]["vocoder"]
