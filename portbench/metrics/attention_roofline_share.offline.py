"""The attention kernel's share of its roofline: the frozen bound of every
attention call of the window (4 encoder calls over the padded text, 6
decoder calls over max_mel_len frames, each over its mask's valid keys;
`costs.attention_cost`) over the device time under `votw::attention_core`."""
from pbcore import costs

NAME = "attention_roofline_share.offline"
UNIT = "%"
LAYER = "attention kernel B1 (ops/attention.py, csrc/flash_mha.cu)"
SOURCE = "device_trace"
MOVES = "audio_x_realtime"
OP = "votw::attention_core"


def read(ctx):
    tr, ac = ctx.get("trace"), ctx["cfg"]["acoustic"]
    if not tr or not tr["device_s"].get(OP):
        return None
    heads, dk = ac["heads"], ac["hidden"] // ac["heads"]
    bound = 0.0
    for c in ctx["calls"]:
        enc = costs.attention_cost(c["B"], c["C"], heads, dk, sum(c["src_lens"]), ac["dtype"])
        dec = costs.attention_cost(c["B"], c["T"], heads, dk, sum(c["mel_lens"]), ac["dtype"])
        bound += ac["encoder_layers"] * costs.bound_s(*enc, ac["dtype"]) \
            + ac["decoder_layers"] * costs.bound_s(*dec, ac["dtype"])
    return 100.0 * bound / tr["device_s"][OP]
