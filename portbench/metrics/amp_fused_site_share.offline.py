"""Share of the vocoder's anti-aliased activation sites in the window that ran
through the one-pass site kernel, in %: the `synth.amp_sites` counts of the
window's spans over `synth.amp_sites` + `synth.amp_sites_plain` (sites run as
PyTorch modules), counted once a call from the generator's route plan. A
count: it repeats exactly for a seed. Read from the port's span recorder
(`visual_onoma_to_wave_tpu_torch.tracing`, found in `sys.modules`); None
where the program records no such count (a vocoder without such sites)."""
import sys

NAME = "amp_fused_site_share.offline"
UNIT = "%"
LAYER = "AMP stage (ops/mrf.py snakebeta_aa kind, ops/amp.py, csrc/amp.cu)"
SOURCE = "program_counter"
MOVES = "audio_x_realtime"


def read(ctx):
    rec = sys.modules.get("visual_onoma_to_wave_tpu_torch.tracing")
    spans = rec.spans() if rec is not None else []
    fused = plain = 0
    for s in spans:
        if s.counts:
            fused += s.counts.get("synth.amp_sites", 0)
            plain += s.counts.get("synth.amp_sites_plain", 0)
    if not fused + plain:
        return None
    return 100.0 * fused / (fused + plain)
