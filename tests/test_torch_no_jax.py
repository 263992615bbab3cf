"""The PyTorch port never imports JAX, nor anything of the JAX package.

In a fresh interpreter with jax, flax, optax, orbax and the JAX package
(`visual_onoma_to_wave_tpu`) made unimportable (and, for the compute core,
yaml and PIL too), the port's modules import; the Synthesizer serves the
demo checkpoint on the CPU with its HiFi-GAN, its Vocos and its iSTFTNet-mel
through the port's own config, symbols and renderer; the port's
`Preprocessor` preprocesses a tiny corpus (built by the parent process, which
may use the JAX package); `chip_smoke.py` (its demo golden phases, the
construction of its full-width models, phase 7's and phase 8's inputs, and
phase 12's HTTP server over the demo iSTFTNet-mel) and
`tools/profile_torch.py` run. A source scan of every port module and those
scripts backs this up for imports inside functions.
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
NO_JAX = JAX_STACK + (JAX_PACKAGE,)

CORE = """
import torch
import visual_onoma_to_wave_tpu_torch.ops
import visual_onoma_to_wave_tpu_torch.models
import visual_onoma_to_wave_tpu_torch.bridge
import visual_onoma_to_wave_tpu_torch.config
import visual_onoma_to_wave_tpu_torch.serve
import visual_onoma_to_wave_tpu_torch.data.audio_io
import visual_onoma_to_wave_tpu_torch.data.symbols
from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer
from visual_onoma_to_wave_tpu_torch.models import get_vocoder
from visual_onoma_to_wave_tpu_torch.models.vocos import VocosGenerator, apply_fused
gen = VocosGenerator(dim=128, intermediate_dim=128, num_layers=1)
with torch.no_grad():
    assert gen(torch.zeros(1, 4, 80)).shape == apply_fused(gen, torch.zeros(1, 4, 80)).shape
    for family, kw in (("iSTFTNet", {"upsample_initial_channel": 32}),
                       ("iSTFTNet-mel", {"upsample_initial_channel": 32}), ("MelGAN", {"ngf": 8})):
        assert get_vocoder(family, **kw)(torch.zeros(1, 4, 80)).shape == (1, 1024)
import numpy as np
from visual_onoma_to_wave_tpu_torch.data.features import extract_features
logmel, energy, kurt = extract_features([np.zeros(3000, np.float32)], [np.array([5, 7], np.int32)],
                                        device="cpu", max_chars=48)
assert logmel.shape[:2] == (1, 80) and energy.shape == kurt.shape == (1, 48)
"""

SERVED = """
from visual_onoma_to_wave_tpu_torch.config import load_config
import visual_onoma_to_wave_tpu_torch.cli
from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer
demo = "examples/checkpoints/demo"
for config, vocoder, family in (("config.json", "vocoder.npz", "HiFiGANGenerator"),
                                ("config_vocos.json", "vocoder_vocos.npz", "VocosGenerator"),
                                ("config_istftnet.json", "vocoder_istftnet_mel.npz",
                                 "ISTFTNetGenerator")):
    synth = Synthesizer.from_checkpoint(load_config(demo + "/" + config),
                                        demo + "/torch/acoustic.npz", demo + "/torch/" + vocoder,
                                        device="cpu")
    r = synth.synthesize("パンパン", "drum")
    assert type(synth.vocoder).__name__ == family and r.wav.shape == (r.mel_len * 256,)
"""

# CORPUS: the path of a config file of a corpus the parent built
PREPROCESS = """
import pathlib
from visual_onoma_to_wave_tpu_torch.config import load_config
from visual_onoma_to_wave_tpu_torch.data.preprocess import Preprocessor
cfg = load_config(CORPUS)
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
for config, vocoder, golden in (("config_istftnet.json", "vocoder_istftnet_mel.npz",
                                 "golden_istftnet.npz"), ("config.json", "vocoder.npz", "golden.npz"),
                                ("config_vocos.json", "vocoder_vocos.npz", "golden_vocos.npz")):
    model, gen = chip_smoke.demo_models("cpu", config, vocoder)
    g = np.load(chip_smoke.DEMO / "torch" / golden)
    out = make_fused_infer(model, gen)(
        {k: torch.from_numpy(g[k]) for k in ("audiotypes", "texts", "src_lens", "image_cells")},
        e_control=torch.from_numpy(g["e_control"]), d_control=torch.from_numpy(g["d_control"]))
    assert np.array_equal(out["mel_lens"].numpy(), g["mel_lens"])
    assert np.abs(out["wav"].numpy() - g["wav"]).max() < 1e-5
assert torch.equal(apply_fused(gen, out["postnet_mel"]), out["wav"])
launches = {}
for vocoder in ("HiFi-GAN", "iSTFTNet-mel", "iSTFTNet", "MelGAN", "Vocos"):
    model, gen, batch = chip_smoke.icassp_b16("cpu", vocoder)
    assert batch["image_cells"].shape == (16, 8, 24, 102)
    launches[vocoder] = chip_smoke.per_call_launches(model, gen)
assert chip_smoke.convnext_blocks(gen) == 8
assert [launches[v]["mrf_stage"] for v in launches] == [4, 1, 2, 0, 0], launches
assert set(chip_smoke.launch_counts()) == {"flash_mha", "convnext_block", "convnext_trunk",
                                           "mel_frontend", "mrf_stage"}
from visual_onoma_to_wave_tpu_torch.ops.mrf import mrf_stage_fused
g = torch.Generator().manual_seed(0)
mats, bias = chip_smoke.mrf_weights(32, g, "cpu")
x = torch.randn(2, 32, 50, generator=g)
assert mrf_stage_fused(x, *mats, bias).shape == x.shape
assert chip_smoke.mrf_cost(x, mats, bias)[0] == 252.0 * 32 * 32 * 2 * 50
assert chip_smoke.bound(67e12, 0)["bound_ms"] == 1e3
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


# phase 12's HTTP server renders glyphs (PIL): only JAX and its package are blocked
SMOKE_SERVED = """
import torch
import chip_smoke
out = chip_smoke.phase_served(torch.device("cpu"), "cpu")
assert out["stats"]["batches"] >= 1 and out["stats"]["requests"] == 4
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
    (NO_JAX + ("yaml", "PIL"), CORE),
    (NO_JAX + ("yaml",), SERVED),
    (NO_JAX + ("yaml",), PREPROCESS),
    (NO_JAX + ("yaml", "PIL"), SMOKE),
    (NO_JAX + ("yaml",), SMOKE_SERVED),
], ids=["compute-core-torch-numpy-only", "served-path-without-jax",
        "preprocess-without-jax", "chip-smoke-without-the-jax-package",
        "chip-smoke-server-without-the-jax-package"])
def test_port_imports_without(blocked, code, tmp_path):
    if "CORPUS" in code:
        from benchmarks.bench_preprocess import build_corpus

        cfg = build_corpus(tmp_path, 6, n_labels=1)
        cfg.save(tmp_path / "config.json")
        code = code.replace("CORPUS", repr(str(tmp_path / "config.json")))
    proc = run_blocked(blocked, code)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), *SCRIPTS]
                 if pattern.search(p.read_text(encoding="utf-8"))]
    assert not offenders


def test_no_jax_package_import_in_scripts():
    """The scripts and every port module (the acceptance check's grep:
    `^\\s*(from|import) visual_onoma_to_wave_tpu(\\.|\\s|$)`)."""
    pattern = re.compile(rf"^\s*(import|from)\s+{JAX_PACKAGE}(\.|\s|$)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), *SCRIPTS]
                 if pattern.search(p.read_text(encoding="utf-8"))]
    assert not offenders

