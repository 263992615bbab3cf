from visual_onoma_to_wave_tpu_torch.models.hifigan import HiFiGANGenerator
from visual_onoma_to_wave_tpu_torch.models.istftnet import ISTFTNetGenerator, build_istftnet
from visual_onoma_to_wave_tpu_torch.models.melgan import MelGANGenerator
from visual_onoma_to_wave_tpu_torch.models.vocoder import get_vocoder
from visual_onoma_to_wave_tpu_torch.models.vocos import VocosGenerator
from visual_onoma_to_wave_tpu_torch.models.vtts import VTTS

__all__ = ["HiFiGANGenerator", "ISTFTNetGenerator", "MelGANGenerator", "VTTS", "VocosGenerator",
           "build_istftnet", "get_vocoder"]
