"""Data layer of the port: host modules and the device DSP of corpus preprocessing.

`data.features` (torch and numpy only) batches clips and extracts their
features on the device; `data.preprocess` runs the whole build with it.
`symbols`, `audio_io`, `renderer`, `labels` and `alignment` are the port's
copies of the JAX package's host modules. Nothing is imported here, so that
importing one of them pulls in no other (PIL, scipy, torch).
"""
