"""Share of the traced window in which no kernel, copy or fill ran on the
device (the union of the profiler's device events; `idle_share` of
tools/profile_torch.py)."""
NAME = "device_idle_share.offline"
UNIT = "%"
LAYER = "device (one H100)"
SOURCE = "device_trace"
MOVES = "audio_x_realtime"


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
