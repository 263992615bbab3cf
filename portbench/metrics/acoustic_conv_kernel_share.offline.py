"""Share of the acoustic model's conv FFN and PostNet convolutions in the
window that ran on the tensor-core conv kernel B7, in %: the
`synth.acoustic_convs` counts of the window's spans over
`synth.acoustic_convs` + `synth.acoustic_convs_plain` (convs run as PyTorch
modules, cuDNN on the card), counted once a call from the model's route plan
inside `synth.acoustic`. A count: it repeats exactly for a seed. Read from
the port's span recorder (`visual_onoma_to_wave_tpu_torch.tracing`, found in
`sys.modules`); None where the program records no such count (a port without
B7)."""
import sys

NAME = "acoustic_conv_kernel_share.offline"
UNIT = "%"
LAYER = "acoustic model (models/vtts.py)"
SOURCE = "program_counter"
MOVES = "audio_x_realtime"


def read(ctx):
    rec = sys.modules.get("visual_onoma_to_wave_tpu_torch.tracing")
    spans = rec.spans() if rec is not None else []
    kernel = plain = 0
    for s in spans:
        if s.counts:
            kernel += s.counts.get("synth.acoustic_convs", 0)
            plain += s.counts.get("synth.acoustic_convs_plain", 0)
    if not kernel + plain:
        return None
    return 100.0 * kernel / (kernel + plain)
