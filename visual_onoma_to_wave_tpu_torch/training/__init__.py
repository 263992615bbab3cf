"""Acoustic-model training of the port (port of visual_onoma_to_wave_tpu/training/).

`loss` (the FastSpeech2 loss), `schedule` (Noam schedule and the Adam step
with clipping and accumulation), `train_state` (train, eval and synth steps)
and `trainer` (the `04_train` loop). Nothing is imported here, so that
importing one of them pulls in no other.
"""
