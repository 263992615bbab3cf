"""PyTorch + CUDA port of visual-onoma-to-wave synthesis for NVIDIA Hopper.

A second package beside the JAX reference `visual_onoma_to_wave_tpu`:
served synthesis (rendered onomatopoeia cells -> VTTS acoustic model ->
HiFi-GAN, iSTFTNet, MelGAN or Vocos -> waveform), corpus formatting and
preprocessing, and acoustic-model training (`training/`) in PyTorch, with
every TPU kernel of the reference as a hand-written CUDA
kernel: the attention core (`csrc/flash_mha.cu`), the fused MRF stage of
iSTFTNet (`csrc/mrf.cu`), the fused mel frontend (`csrc/mel_frontend.cu`)
and the ConvNeXt block and trunk of Vocos (`csrc/convnext.cu`). The host
modules (config, symbols, audio I/O, renderer, labels, alignment,
formatting, preprocessing passes, the training dataset and loader, metrics,
checkpoints and logs, the HTTP server, the browser demo `demo_server` with
its mel figure drawn by PIL) are the port's own copies.

This package imports `torch` and never `jax`, and nothing of the JAX package.
"""

__version__ = "0.1.0"
