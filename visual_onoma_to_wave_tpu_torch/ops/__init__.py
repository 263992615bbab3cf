from visual_onoma_to_wave_tpu_torch.ops.attention import (
    attention_core,
    attention_core_reference,
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

__all__ = [
    "attention_core",
    "attention_core_reference",
    "convnext_block",
    "convnext_block_reference",
    "convnext_trunk",
    "convnext_trunk_reference",
    "expand_char_to_frame",
    "get_mask_from_lengths",
    "length_regulate",
]
