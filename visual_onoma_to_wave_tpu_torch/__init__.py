"""PyTorch + CUDA port of visual-onoma-to-wave synthesis for NVIDIA Hopper.

A second package beside the JAX reference `visual_onoma_to_wave_tpu`:
served synthesis (rendered onomatopoeia cells -> VTTS acoustic model ->
HiFi-GAN or Vocos -> waveform) in PyTorch, with the attention core of every
FFT block (`ops/attention.py`, `csrc/flash_mha.cu`) and the ConvNeXt block
and trunk of Vocos (`ops/convnext.py`, `csrc/convnext.cu`) as hand-written
CUDA kernels.
Host-side modules without a JAX import (config, renderer, symbols, audio
I/O, the HTTP server) are reused from the reference package, not re-ported.

This package imports `torch` and never `jax`.
"""

__version__ = "0.1.0"
