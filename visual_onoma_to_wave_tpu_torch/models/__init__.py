from visual_onoma_to_wave_tpu_torch.models.hifigan import HiFiGANGenerator
from visual_onoma_to_wave_tpu_torch.models.vocoder import get_vocoder
from visual_onoma_to_wave_tpu_torch.models.vocos import VocosGenerator
from visual_onoma_to_wave_tpu_torch.models.vtts import VTTS

__all__ = ["HiFiGANGenerator", "VTTS", "VocosGenerator", "get_vocoder"]
