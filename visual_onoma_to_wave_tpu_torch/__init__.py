"""PyTorch + CUDA port of visual-onoma-to-wave synthesis for NVIDIA Hopper.

A second package beside the JAX reference `visual_onoma_to_wave_tpu`:
served synthesis (rendered onomatopoeia cells -> VTTS acoustic model ->
HiFi-GAN, iSTFTNet, MelGAN or Vocos -> waveform) and corpus preprocessing in
PyTorch, with every TPU kernel of the reference as a hand-written CUDA
kernel: the attention core (`csrc/flash_mha.cu`), the fused MRF stage of
iSTFTNet (`csrc/mrf.cu`), the fused mel frontend (`csrc/mel_frontend.cu`)
and the ConvNeXt block and trunk of Vocos (`csrc/convnext.cu`). The host
modules (config, symbols, audio I/O, renderer, alignment, preprocessing
passes, the HTTP server) are the port's own copies.

This package imports `torch` and never `jax`, and nothing of the JAX package.
"""

__version__ = "0.1.0"
