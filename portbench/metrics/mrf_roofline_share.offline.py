"""The MRF kernel's share of its roofline: the frozen bound of every MRF
stage of the window (the padded batch at the stage's width and frames;
`costs.mrf_stage_cost`) over the device time under `votw::mrf_stage_fused`,
every kernel the op launches whichever design `mrf_route` picks."""
from pbcore import costs

NAME = "mrf_roofline_share.offline"
UNIT = "%"
LAYER = "MRF kernel B2 (ops/mrf.py, csrc/mrf.cu)"
SOURCE = "device_trace"
MOVES = "audio_x_realtime"
OP = "votw::mrf_stage_fused"


def read(ctx):
    tr, v = ctx.get("trace"), ctx["cfg"]["vocoder"]
    if not tr or not tr["device_s"].get(OP) or v["family"] != "hifigan":
        return None
    bound = 0.0
    for c in ctx["calls"]:
        t = c["T"]
        for i, u in enumerate(v["upsample_rates"]):
            t *= u
            ch = v["upsample_initial_channel"] // 2 ** (i + 1)
            cost = costs.mrf_stage_cost(c["B"], ch, t, v["dtype"], v["resblock_kernel_sizes"],
                                        v["resblock_dilations"])
            bound += costs.bound_s(*cost, v["dtype"])
    return 100.0 * bound / tr["device_s"][OP]
