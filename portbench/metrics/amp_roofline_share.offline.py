"""The AMP stage's share of its roofline: the frozen bound of every AMP stage
of the window (the padded batch at the stage's width and frames;
`reference/bigvgan.py::amp_stage_cost`: its 18 convs and 18 sites' FIR taps,
x in and out once, the weights and site parameters once) over the device
time under `votw::mrf_stage_fused`, every kernel the op launches (the site
kernel and cuDNN's convs). None for a vocoder other than BigVGAN."""
from pbcore import costs

NAME = "amp_roofline_share.offline"
UNIT = "%"
LAYER = "AMP stage (ops/mrf.py snakebeta_aa kind, ops/amp.py, csrc/amp.cu)"
SOURCE = "device_trace"
MOVES = "audio_x_realtime"
OP = "votw::mrf_stage_fused"


def read(ctx):
    tr, v = ctx.get("trace"), ctx["cfg"]["vocoder"]
    if not tr or not tr["device_s"].get(OP) or v["family"] != "bigvgan":
        return None
    ref = ctx["families"]["vocoder"]
    bound = 0.0
    for c in ctx["calls"]:
        t = c["T"]
        for i, u in enumerate(v["upsample_rates"]):
            t *= u
            ch = v["upsample_initial_channel"] // 2 ** (i + 1)
            cost = ref.amp_stage_cost(c["B"], ch, t, v["dtype"], v["resblock_kernel_sizes"],
                                      v["resblock_dilations"])
            bound += costs.bound_s(*cost, v["dtype"])
    return 100.0 * bound / tr["device_s"][OP]
