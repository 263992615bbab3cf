"""The whole fused step's share of the card's peak: the model FLOPs every
request of the traced window needs at its own lengths (characters and mel
frames; `costs.request_time_at_peak`, each part at its compute dtype's
peak; each family's `flops` in `reference/`) over the window's seconds."""
from pbcore import costs

NAME = "mfu.offline"
UNIT = "%"
LAYER = "fused step (synthesis.py make_fused_infer)"
SOURCE = "host_clock"
MOVES = "audio_x_realtime"


def read(ctx):
    tr, calls = ctx.get("trace"), [c for c in ctx.get("calls", ()) if "n" in c]
    if not tr or not calls:
        return None
    fam = ctx["families"]
    at_peak = sum(costs.request_time_at_peak(ctx["cfg"], fam, int(c["src_lens"][i]),
                                             max(1, int(c["mel_lens"][i])))
                  for c in calls for i in range(c["n"]))
    return 100.0 * at_peak / tr["window_s"]
