"""Data layer of the port: the device DSP of corpus preprocessing.

`data.features` (torch and numpy only) batches clips and extracts their
features on the device; `data.preprocess` is the reference `Preprocessor`
with that device DSP swapped in. Nothing is imported here, so that importing
`data.features` does not pull in the reference package.
"""
