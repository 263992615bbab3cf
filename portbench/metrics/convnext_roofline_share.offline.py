"""The ConvNeXt kernel's share of its roofline: the frozen bound of every
block of the window (the padded batch at max_mel_len frames;
`costs.convnext_block_cost`) over the device time under
`votw::convnext_block`."""
from pbcore import costs

NAME = "convnext_roofline_share.offline"
UNIT = "%"
LAYER = "ConvNeXt kernel B4 (ops/convnext.py, csrc/convnext.cu)"
SOURCE = "device_trace"
MOVES = "audio_x_realtime"
OP = "votw::convnext_block"


def read(ctx):
    tr, v = ctx.get("trace"), ctx["cfg"]["vocoder"]
    if not tr or not tr["device_s"].get(OP) or v["family"] != "vocos":
        return None
    bound = 0.0
    for c in ctx["calls"]:
        cost = costs.convnext_block_cost(c["B"], c["T"], v["dim"], v["intermediate_dim"], 7,
                                         v["dtype"])
        bound += v["num_layers"] * costs.bound_s(*cost, v["dtype"])
    return 100.0 * bound / tr["device_s"][OP]
