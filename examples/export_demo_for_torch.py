"""Export the committed demo checkpoints for the PyTorch port.

Runs where JAX runs (the CPU is enough):

    python examples/export_demo_for_torch.py

and writes, under examples/checkpoints/demo/torch/, each of these files that
is not there yet (it never rewrites one: after the demo checkpoints change,
delete the files to export them again):

  * acoustic.npz, vocoder.npz: the orbax parameter trees of
    examples/checkpoints/demo/{acoustic,vocoder}, keyed by '/'-joined flax
    path, which `visual_onoma_to_wave_tpu_torch.bridge` maps onto the port's
    modules (the port does not read orbax);
  * golden.npz: four fixed requests from the demo test split served by the
    JAX `Synthesizer` (mixed lengths and audiotypes, per-item e/d controls):
    the exact padded inputs of its fused acoustic + vocoder step (audiotypes,
    texts, src_lens, image_cells from its renderer, e_control, d_control)
    and the outputs duration_rounded, mel_lens, postnet_mel and wav;
  * vocoder_vocos.npz: the orbax tree of examples/checkpoints/demo/vocoder_vocos;
  * golden_vocos.npz: the same four requests served by the JAX `Synthesizer`
    on config_vocos.json (same acoustic checkpoint, the demo Vocos vocoder
    on its plain block path), with the same inputs and outputs;
  * vocoder_istftnet_mel.npz: the orbax tree of
    examples/checkpoints/demo/vocoder_istftnet_mel;
  * golden_istftnet.npz: the same four requests served by the JAX
    `Synthesizer` on config_istftnet.json (the demo iSTFTNet-mel vocoder).

`port_demo_config` loads a demo config with the port's own loader, for the
port's tests and scripts (no JAX there).
"""
from __future__ import annotations

import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

DEMO = pathlib.Path(__file__).resolve().parent / "checkpoints" / "demo"
OUT = DEMO / "torch"

# (text, audiotype, width_rates, e_control, d_control) from preprocessed/test.txt
GOLDEN_REQUESTS = [
    ("バウバウ", "bell", [1.0, 0.6, 1.0, 0.6], 1.0, 1.0),
    ("チパチパチパ", "drum", None, 1.0, 1.0),
    ("パシウドパシウド", "bell", None, 1.2, 1.0),
    ("シトパリ", "drum", None, 1.0, 1.5),
]
GOLDEN_INPUTS = ("audiotypes", "texts", "src_lens", "image_cells", "e_control", "d_control")
GOLDEN_OUTPUTS = ("duration_rounded", "mel_lens", "postnet_mel", "wav")


def _at_demo(cfg):
    """`cfg` with its paths pointed at this checkout's demo directory."""
    return cfg.replace(path=cfg.path.__class__(
        corpus="", formatted="", preprocessed=str(DEMO / "preprocessed"), font="",
        ckpt=str(DEMO / "preprocessed"), log="", result=""))


def demo_config(name: str = "config.json"):
    """A demo config (config.json: HiFi-GAN; config_vocos.json: Vocos;
    config_istftnet.json: iSTFTNet-mel) through the JAX package's loader."""
    from visual_onoma_to_wave_tpu.cli import load_config

    return _at_demo(load_config(str(DEMO / name)))


def port_demo_config(name: str = "config.json"):
    """`demo_config` through the port's `config.load_config`."""
    from visual_onoma_to_wave_tpu_torch.config import load_config

    return _at_demo(load_config(DEMO / name))


def weight_trees(names=("acoustic", "vocoder")) -> dict[str, dict]:
    """{name: {...}} for the demo checkpoint directories `names`, as nested
    dicts of numpy arrays."""
    import jax

    from visual_onoma_to_wave_tpu.utils.checkpoint import load_params

    return {name: jax.tree.map(np.asarray, load_params(DEMO / name)) for name in names}


def golden(config: str = "config.json", vocoder: str = "vocoder") -> dict[str, np.ndarray]:
    """Serve GOLDEN_REQUESTS through the JAX Synthesizer (single device) with
    the demo config `config` and vocoder checkpoint `vocoder`, and capture
    the inputs and outputs of its fused step."""
    from visual_onoma_to_wave_tpu.synthesis import Synthesizer

    synth = Synthesizer.from_checkpoint(demo_config(config), acoustic=str(DEMO / "acoustic"),
                                        vocoder=str(DEMO / vocoder), mesh=None)
    step = synth._get_fused_step()
    captured: dict[str, np.ndarray] = {}

    def spy(state, vocoder_params, batch, e_control, d_control):
        out = step(state, vocoder_params, batch, e_control=e_control, d_control=d_control)
        captured.update({k: np.asarray(v) for k, v in batch.items()})
        captured.update(e_control=np.asarray(e_control), d_control=np.asarray(d_control))
        captured.update({k: np.asarray(out[k]) for k in GOLDEN_OUTPUTS})
        return out

    synth._fused_step = spy
    texts, types, rates, e, d = zip(*GOLDEN_REQUESTS)
    synth.synthesize_batch(list(texts), list(types), width_rates=list(rates),
                           e_control=list(e), d_control=list(d))
    return captured


# file -> how to make it
EXPORTS = {
    "acoustic.npz": lambda: weight_trees(("acoustic",))["acoustic"],
    "vocoder.npz": lambda: weight_trees(("vocoder",))["vocoder"],
    "golden.npz": golden,
    "vocoder_vocos.npz": lambda: weight_trees(("vocoder_vocos",))["vocoder_vocos"],
    "golden_vocos.npz": lambda: golden("config_vocos.json", "vocoder_vocos"),
    "vocoder_istftnet_mel.npz":
        lambda: weight_trees(("vocoder_istftnet_mel",))["vocoder_istftnet_mel"],
    "golden_istftnet.npz": lambda: golden("config_istftnet.json", "vocoder_istftnet_mel"),
}


def main() -> None:
    from visual_onoma_to_wave_tpu_torch.bridge import save_npz

    OUT.mkdir(parents=True, exist_ok=True)
    for name, make in EXPORTS.items():
        path = OUT / name
        if path.exists():
            print(f"kept {path}")
            continue
        tree = make()
        if name.startswith("golden"):
            np.savez_compressed(path, **tree)
            print(json.dumps({k: list(v.shape) for k, v in tree.items()}))
        else:
            save_npz(path, tree)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
