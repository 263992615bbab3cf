from visual_onoma_to_wave_tpu_torch.ops.attention import (
    attention_core,
    attention_core_reference,
)
from visual_onoma_to_wave_tpu_torch.ops.conv1d import (
    conv1d_tc,
    conv1d_tc_reference,
)
from visual_onoma_to_wave_tpu_torch.ops.convnext import (
    convnext_block,
    convnext_block_reference,
    convnext_trunk,
    convnext_trunk_reference,
)
from visual_onoma_to_wave_tpu_torch.ops.length_regulator import (
    expand_char_to_frame,
    get_mask_from_lengths,
    length_regulate,
)
from visual_onoma_to_wave_tpu_torch.ops.mel import (
    fused_clip_features,
    fused_logmel_energy,
    mel_frontend,
    mel_frontend_reference,
)
from visual_onoma_to_wave_tpu_torch.ops.mrf import (
    mrf_stage_fused,
    mrf_stage_fused_reference,
    pack_mrf_weights,
)

__all__ = [
    "attention_core",
    "attention_core_reference",
    "conv1d_tc",
    "conv1d_tc_reference",
    "convnext_block",
    "convnext_block_reference",
    "convnext_trunk",
    "convnext_trunk_reference",
    "expand_char_to_frame",
    "fused_clip_features",
    "fused_logmel_energy",
    "get_mask_from_lengths",
    "length_regulate",
    "mel_frontend",
    "mel_frontend_reference",
    "mrf_stage_fused",
    "mrf_stage_fused_reference",
    "pack_mrf_weights",
]
