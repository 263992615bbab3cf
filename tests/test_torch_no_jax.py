"""The PyTorch port never imports JAX.

In a fresh interpreter with jax, flax, optax, orbax (and, for the compute
core, yaml and PIL) made unimportable, the port's modules import; without
yaml and PIL blocked, the Synthesizer serves the demo checkpoint on the
CPU, with its HiFi-GAN and with its Vocos, and the port's `Preprocessor`
preprocesses a tiny corpus. `chip_smoke.py` (its demo golden phases,
HiFi-GAN and Vocos, the construction of its full-width models, and phase
7's case grid, seeded clips and feature stage) and `tools/profile_torch.py`
also run with the JAX package (`visual_onoma_to_wave_tpu`) itself
unimportable. A source scan of the package and those scripts backs this up
for imports inside functions.
"""
from __future__ import annotations

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "visual_onoma_to_wave_tpu_torch"
SCRIPTS = (ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch.py")
JAX_STACK = ("jax", "jaxlib", "flax", "optax", "orbax")
JAX_PACKAGE = "visual_onoma_to_wave_tpu"

CORE = """
import torch
import visual_onoma_to_wave_tpu_torch.ops
import visual_onoma_to_wave_tpu_torch.models
import visual_onoma_to_wave_tpu_torch.bridge
from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer
from visual_onoma_to_wave_tpu_torch.models.vocos import VocosGenerator, apply_fused
gen = VocosGenerator(dim=128, intermediate_dim=128, num_layers=1)
with torch.no_grad():
    assert gen(torch.zeros(1, 4, 80)).shape == apply_fused(gen, torch.zeros(1, 4, 80)).shape
import numpy as np
from visual_onoma_to_wave_tpu_torch.data.features import extract_features
logmel, energy, kurt = extract_features([np.zeros(3000, np.float32)], [np.array([5, 7], np.int32)],
                                        device="cpu", max_chars=48)
assert logmel.shape[:2] == (1, 80) and energy.shape == kurt.shape == (1, 48)
"""

SERVED = """
from visual_onoma_to_wave_tpu.cli import load_config
import visual_onoma_to_wave_tpu_torch.cli
from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer
demo = "examples/checkpoints/demo"
synth = Synthesizer.from_checkpoint(load_config(demo + "/config.json"),
                                    demo + "/torch/acoustic.npz", demo + "/torch/vocoder.npz",
                                    device="cpu")
r = synth.synthesize("パンパン", "drum")
assert r.wav.shape == (r.mel_len * 256,)
synth = Synthesizer.from_checkpoint(load_config(demo + "/config_vocos.json"),
                                    demo + "/torch/acoustic.npz", demo + "/torch/vocoder_vocos.npz",
                                    device="cpu")
r = synth.synthesize("パンパン", "drum")
assert type(synth.vocoder).__name__ == "VocosGenerator" and r.wav.shape == (r.mel_len * 256,)
"""

PREPROCESS = """
import pathlib, tempfile
from benchmarks.bench_preprocess import build_corpus
from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor
with tempfile.TemporaryDirectory() as root:
    cfg = build_corpus(pathlib.Path(root), 6, n_labels=1)
    Preprocessor(cfg, num_workers=1, device="cpu").build(verbose=False)
    out = pathlib.Path(cfg.path.preprocessed)
    assert len(list((out / "mel" / "label0").glob("*.npy"))) >= 6
    assert (out / "stats.json").exists() and (out / "train.txt").exists()
"""

# what chip_smoke's phases and the profiler build, on the CPU (phase 3's
# models run on the golden inputs; phase 4's full-width models are only built)
SMOKE = """
import numpy as np, torch
sys.path.insert(0, "tools")
import chip_smoke, profile_torch
from visual_onoma_to_wave_tpu_torch.models.vocos import apply_fused
from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer
for config, vocoder, golden in (("config.json", "vocoder.npz", "golden.npz"),
                                ("config_vocos.json", "vocoder_vocos.npz", "golden_vocos.npz")):
    model, gen = chip_smoke.demo_models("cpu", config, vocoder)
    g = np.load(chip_smoke.DEMO / "torch" / golden)
    out = make_fused_infer(model, gen)(
        {k: torch.from_numpy(g[k]) for k in ("audiotypes", "texts", "src_lens", "image_cells")},
        e_control=torch.from_numpy(g["e_control"]), d_control=torch.from_numpy(g["d_control"]))
    assert np.array_equal(out["mel_lens"].numpy(), g["mel_lens"])
assert torch.equal(apply_fused(gen, out["postnet_mel"]), out["wav"])
for vocoder in ("HiFi-GAN", "Vocos"):
    model, gen, batch = chip_smoke.icassp_b16("cpu", vocoder)
    assert batch["image_cells"].shape == (16, 8, 24, 102)
assert chip_smoke.convnext_blocks(gen) == 8
from visual_onoma_to_wave_tpu_torch.data.features import extract_features, pad_batch
from visual_onoma_to_wave_tpu_torch.ops.mel import mel_frontend, mel_frontend_reference
for name, x, win in chip_smoke.mel_cases():
    x = torch.from_numpy(x)
    chip_smoke.check_mel_frontend(name, chip_smoke._host(mel_frontend(x, win_length=win)),
                                  chip_smoke._host(mel_frontend_reference(x, win_length=win)))
clips, durs = chip_smoke.feature_clips(16)
out = chip_smoke._host(extract_features(clips, durs, device="cpu", max_chars=chip_smoke.MAX_CHARS))
batch, dur = pad_batch(clips, durs, n_fft=1024, hop_length=256, max_chars=chip_smoke.MAX_CHARS)
x = torch.from_numpy(batch)
plain = chip_smoke._host(chip_smoke.plain_clip_features(x, torch.from_numpy(dur),
                                                        chip_smoke.MAX_CHARS))
assert all(np.array_equal(a, b, equal_nan=True) for a, b in zip(out, plain))
exact = chip_smoke.logmel_float64(x).numpy()
chip_smoke.check_path_batch("cpu", (exact, *plain[1:]), plain, exact)
"""


def run_blocked(blocked, code: str) -> subprocess.CompletedProcess:
    prelude = ("import sys\n"
               f"for name in {tuple(blocked)!r}:\n"
               "    sys.modules[name] = None   # import raises ImportError\n")
    epilogue = (f"\nleaked = [m for m in sys.modules if m.split('.')[0] in {tuple(blocked)!r}"
                " and sys.modules[m] is not None]\nassert not leaked, leaked\n")
    return subprocess.run([sys.executable, "-c", prelude + code + epilogue], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("blocked,code", [
    (JAX_STACK + ("yaml", "PIL"), CORE),
    (JAX_STACK, SERVED),
    (JAX_STACK, PREPROCESS),
    (JAX_STACK + ("yaml", "PIL", JAX_PACKAGE), SMOKE),
], ids=["compute-core-torch-numpy-only", "served-path-without-jax",
        "preprocess-without-jax", "chip-smoke-without-the-jax-package"])
def test_port_imports_without(blocked, code):
    proc = run_blocked(blocked, code)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), *SCRIPTS]
                 if pattern.search(p.read_text(encoding="utf-8"))]
    assert not offenders


def test_no_jax_package_import_in_scripts():
    pattern = re.compile(rf"^\s*(import|from)\s+{JAX_PACKAGE}\b", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in SCRIPTS
                 if pattern.search(p.read_text(encoding="utf-8"))]
    assert not offenders
