"""The PyTorch port never imports JAX, nor anything of the JAX package.

In a fresh interpreter with jax, flax, optax, orbax and the JAX package
(`visual_onoma_to_wave_tpu`) made unimportable (and, for the compute core,
yaml and PIL too), the port's modules import; the Synthesizer serves the
demo checkpoint on the CPU with its HiFi-GAN, its Vocos and its iSTFTNet-mel
through the port's own config, symbols and renderer; the port's
`Preprocessor` preprocesses a tiny corpus (built by the parent process, which
may use the JAX package); `chip_smoke.py` (its demo golden phases, the
construction of its full-width models, phase 7's and phase 8's inputs,
phase 12's HTTP server over the demo iSTFTNet-mel and phase 16's demo
server) and `tools/profile_torch.py` run; `cli synthesize-batch`, `Synthesizer.vocode`
and chunked vocoding run on a BigVGAN config (its weights written by the
parent process); the train path runs (`cli format`,
`prepare-tg`, `preprocess`, `train` and `evaluate` on a tiny corpus, on the
CPU, the trainer's loader with spawned workers), and so does
`tools/acoustic_floor_torch.py` at a small size; `cli demo` starts the demo
server, answers one request and stops; `tools/eval_quality_demo_torch.py`'s
scoring functions score the three committed vocoders on a clip; `cli
train-vocoder` trains HiFi-GAN V1 two steps on a tiny wav directory, its
generator.npz then serving `cli synthesize --vocoder` with a config that
names it, and `tools/vocoder_longrun_torch.py` trains and scores
iSTFTNet-mel at a tiny batch; `cli export` writes a CPU artifact of the
demo checkpoint, `cli serve --exported` serves one HTTP request from it,
and `parallel.make_sharded_synth` runs two CPU replicas; in bf16 the demo
synthesizer serves (HiFi-GAN and Vocos), the acoustic model takes a train
step, `cli train-vocoder --bf16` takes a GAN step, and chip_smoke's phase-20
models build; `cli convert-acoustic` and `convert-vocoder` (HiFi-GAN and
MelGAN) convert reference checkpoints the script writes, `cli doctor`
checks the formatted and preprocessed stages of a tiny corpus, `cli
synthesize --restore-step -1` serves a training checkpoint, and
`griffin_lim`, the sample figure, sharded serving and the feature pass over
two CPU devices run. A source scan of
every port module (`demo_server.py`, `utils/plotting.py`,
`models/hifigan_disc.py`, `training/vocoder_trainer.py`, `export.py` and
`parallel/` included) and those scripts backs this up for imports inside
functions.
"""
from __future__ import annotations

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "visual_onoma_to_wave_tpu_torch"
SCRIPTS = (ROOT / "chip_smoke.py", ROOT / "tools" / "profile_torch.py",
           ROOT / "tools" / "acoustic_floor_torch.py", ROOT / "tools" / "eval_quality_demo_torch.py",
           ROOT / "tools" / "vocoder_longrun_torch.py",
           ROOT / "tools" / "gan_step_ab_torch.py", ROOT / "tools" / "corpus_compare_torch.py",
           ROOT / "tools" / "step_compare_torch.py", ROOT / "tools" / "trajectory_compare_torch.py",
           ROOT / "tools" / "bf16_attention_gap_torch.py")
# port modules the source scans must reach (added with the demo server and
# with GAN vocoder training)
SCANNED = ("demo_server.py", "utils/plotting.py", "models/hifigan_disc.py",
           "training/vocoder_trainer.py", "export.py", "parallel/distributed.py",
           "parallel/serving.py", "precision.py", "data/doctor.py", "models/convert_acoustic.py",
           "utils/checkpoint.py", "data/features.py", "ops/stft.py", "data/native.py")
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

# BIGVGAN_DEMO: a directory where the parent wrote a demo config with a tiny BigVGAN
# vocoder, its weights (bigvgan.npz) and batch rows
VOCODE = """
import pathlib, numpy as np, torch
from visual_onoma_to_wave_tpu_torch.cli import main
from visual_onoma_to_wave_tpu_torch.config import load_config
from visual_onoma_to_wave_tpu_torch.models.hifigan import vocoder_infer_chunked
from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer
work, acoustic = pathlib.Path(BIGVGAN_DEMO), "examples/checkpoints/demo/torch/acoustic.npz"
assert main(["synthesize-batch", str(work / "config.json"), str(work / "rows.txt"),
             str(work / "out"), "--acoustic", acoustic, "--vocoder", str(work / "bigvgan.npz"),
             "--batch-size", "2", "--device", "cpu"]) == 0
assert sorted(p.name for p in (work / "out").iterdir()) == ["00000.wav", "00001.wav", "clip.wav"]
synth = Synthesizer.from_checkpoint(load_config(work / "config.json"), acoustic,
                                    str(work / "bigvgan.npz"), device="cpu")
assert type(synth.vocoder).__name__ == "BigVGANGenerator"
wavs = synth.vocode(np.full((2, 10, 80), -5.0, np.float32), [10, 7])
assert [w.shape for w in wavs] == [(2560,), (1792,)]
assert vocoder_infer_chunked(synth.vocoder, torch.zeros(1, 40, 80), chunk_frames=16).shape == \
    (1, 40 * 256)
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

# the train path through the port's command line on a tiny corpus (the
# generator is the port's own; a tiny model; 4 steps; two loader workers).
# The blocker lives in this interpreter only, so before the loader's pool
# shuts down each worker reports the blocked modules it holds: none.
TRAIN = """
import json, pathlib, tempfile, torch
torch.set_num_threads(1)
from visual_onoma_to_wave_tpu_torch.cli import main
from visual_onoma_to_wave_tpu_torch.data.loader import ProcessLoader
ProcessLoader.MIN_BATCHES_FOR_PROCS = 1      # the workers load even this tiny epoch
in_workers, close = [], ProcessLoader.close
probe = f"{{m.split('.')[0] for m in __import__('sys').modules}} & set({BLOCKED!r})"
def probed_close(self):
    if self._pool is not None:
        in_workers.append(set().union(*self._pool.map(eval, [probe] * 8)))
    close(self)
ProcessLoader.close = probed_close
from visual_onoma_to_wave_tpu_torch.data.synthetic_corpus import build_corpus, work_config
sys.path.insert(0, "tools")
from acoustic_floor_torch import SMALL_MODEL
root = pathlib.Path(tempfile.mkdtemp())
raw, ono = build_corpus(root, 6)
cfg = work_config(root, ono, 4)
cfg["dataset"]["valtest_id"] = [1, 3]
cfg["model"] = SMALL_MODEL
cfg["train"]["optimizer"]["batch_size"] = 2
cfg["train"]["step"].update(val_step=2, val_metrics=True, save_step=2, synth_step=4)
path = root / "cfg.json"
path.write_text(json.dumps(cfg))
main(["format", str(path), str(raw)])
main(["prepare-tg", str(path)])
main(["preprocess", str(path), "--device", "cpu", "--num-workers", "1"])
main(["train", str(path), "--device", "cpu", "--loader-workers", "2"])
main(["evaluate", str(path), "--device", "cpu", "--restore-step", "-1", "--metrics"])
assert sorted(p.name for p in (root / "out" / "ckpt").iterdir()) == ["2", "4", "symbols.json"]
assert in_workers == [set()], in_workers
"""

TOOL = """
sys.path.insert(0, "tools")
import tempfile, torch, acoustic_floor_torch
import visual_onoma_to_wave_tpu_torch.data.preprocess as preprocess
torch.set_num_threads(1)
preprocess.NUM_HOST_WORKERS = 2        # a small pool beside the other test workers
assert acoustic_floor_torch.main(["--small", "--steps", "2", "--val-step", "1", "--n-per-class",
                                  "14", "--batch", "4", "--device", "cpu",
                                  "--work", tempfile.mkdtemp()]) == 0
"""


# `cli demo` on the demo checkpoint: the server runs in a thread, answers one
# request and is shut down
DEMO = """
import base64, http.client, io, json, socket, threading, time, wave
import visual_onoma_to_wave_tpu_torch.demo_server as demo_server
from visual_onoma_to_wave_tpu_torch.cli import main
started, serve = [], demo_server.DemoServer.serve_forever
def serve_forever(self):
    started.append(self)
    serve(self)
demo_server.DemoServer.serve_forever = serve_forever
with socket.socket() as s:
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
d = "examples/checkpoints/demo"
t = threading.Thread(target=main, args=(["demo", d + "/config.json", "--acoustic",
                     d + "/torch/acoustic.npz", "--vocoder", d + "/torch/vocoder.npz",
                     "--port", str(port), "--device", "cpu"],), daemon=True)
t.start()
for _ in range(600):
    if started:
        break
    time.sleep(0.1)
conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
conn.request("POST", "/api/synthesize", json.dumps({"text": "パンパン", "audiotype": "drum"}),
             {"Content-Type": "application/json"})
resp = conn.getresponse()
r = json.loads(resp.read())
assert resp.status == 200
with wave.open(io.BytesIO(base64.b64decode(r["wav_b64"])), "rb") as w:
    assert w.getnframes() == r["mel_frames"] * 256
started[0].httpd.shutdown()
t.join(timeout=30)
assert not t.is_alive()
"""

# the quality gate's scoring on one random clip saved as a preprocessed val row
GATE = """
import json, pathlib, tempfile, numpy as np
sys.path.insert(0, "tools")
import eval_quality_demo_torch as gate
from visual_onoma_to_wave_tpu_torch.config import load_config
pre = pathlib.Path(tempfile.mkdtemp())
(pre / "audio" / "drum").mkdir(parents=True)
(pre / "val.txt").write_text("clip|drum|24||パン\\n")
np.save(pre / "audio" / "drum" / "clip.npy",
        np.random.default_rng(0).uniform(-0.5, 0.5, 5000).astype(np.float32))
audio = load_config(gate.DEMO / "config.json").audio
out = gate.score_committed_vocoders(gate.DEMO, pre, audio, "cpu")
assert sorted(out) == ["hifigan", "istftnet_mel", "vocos"] and out["vocos"]["clips"] == 1
gate.assert_finite(out)
stats = gate.DEMO / "preprocessed" / "stats.json"
gate.check_stats(stats, stats)
"""


# GAN vocoder training through the command line (HiFi-GAN V1 at its full
# width, two steps at batch 1 x 2048 samples on three wavs), the trained
# generator served by `cli synthesize`, and the long-run tool at a tiny size
VOCODER_TRAIN = """
import json, pathlib, tempfile, wave, numpy as np, torch
torch.set_num_threads(2)
sys.path.insert(0, "tools")
from visual_onoma_to_wave_tpu_torch.cli import main
from visual_onoma_to_wave_tpu_torch.data.audio_io import write_wav
import vocoder_longrun_torch
work = pathlib.Path(tempfile.mkdtemp())
(work / "wavs").mkdir()
t = np.arange(6000) / 22050
for i in range(3):
    write_wav(work / "wavs" / f"c{i}.wav", (0.4 * np.sin(2 * np.pi * (220 + 90 * i) * t))
              .astype(np.float32), 22050)
main(["train-vocoder", str(work / "wavs"), str(work / "voc"), "--steps", "2", "--batch-size",
      "1", "--segment-size", "2048", "--save-every", "1", "--ema-decay", "0.9", "--device", "cpu"])
assert sorted(p.name for p in (work / "voc" / "2").iterdir()) == [
    "full_state.npz", "generator.npz", "generator_ema.npz", "sampler_state.json"]
demo = pathlib.Path("examples/checkpoints/demo")
cfg = json.loads((demo / "config.json").read_text())
cfg["model"]["vocoder_kwargs"] = {}
cfg["path"]["preprocessed"] = str(demo / "preprocessed")
(work / "config.json").write_text(json.dumps(cfg))
main(["synthesize", str(work / "config.json"), "--acoustic", str(demo / "torch" / "acoustic.npz"),
      "--vocoder", str(work / "voc" / "2" / "generator.npz"), "--text", "パン", "--audiotype",
      "drum", "--out", str(work / "out.wav"), "--device", "cpu"])
with wave.open(str(work / "out.wav"), "rb") as w:
    assert w.getnframes() > 0 and w.getnframes() % 256 == 0
assert vocoder_longrun_torch.main(["--families", "istftnet-mel", "--steps", "2", "--every", "1",
                                   "--batch", "1", "--segment-size", "2048",
                                   "--device", "cpu"]) == 0
import shutil
shutil.rmtree(work)     # two full-state checkpoints of the full-width GAN: 2.3 GB
"""


# bf16 compute: the demo synthesizer served in bf16 (`train.compute_dtype`
# and the vocoder's `dtype` in `model.vocoder_kwargs`), a bf16 acoustic train
# step, `cli train-vocoder --bf16` one step, and chip_smoke's bf16 models of
# phase 20 built with their launches per call
BF16 = """
import dataclasses, pathlib, shutil, tempfile, numpy as np, torch
torch.set_num_threads(2)
import chip_smoke
from visual_onoma_to_wave_tpu_torch.cli import main
from visual_onoma_to_wave_tpu_torch.config import load_config
from visual_onoma_to_wave_tpu_torch.data.audio_io import write_wav
from visual_onoma_to_wave_tpu_torch.models import VTTS
from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer
from visual_onoma_to_wave_tpu_torch.training.schedule import NoamAdam
from visual_onoma_to_wave_tpu_torch.training.train_state import TrainState, train_step
demo = "examples/checkpoints/demo"
for config, vocoder in (("config.json", "vocoder.npz"), ("config_vocos.json", "vocoder_vocos.npz")):
    cfg = load_config(demo + "/" + config)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype="bfloat16"),
                      model=dataclasses.replace(cfg.model, vocoder_kwargs={
                          **cfg.model.vocoder_kwargs, "dtype": "bfloat16"}))
    synth = Synthesizer.from_checkpoint(cfg, demo + "/torch/acoustic.npz",
                                        demo + "/torch/" + vocoder, device="cpu")
    assert synth.model.dtype == synth.vocoder.dtype == torch.bfloat16
    r = synth.synthesize("パンパン", "drum")
    assert r.wav.dtype == np.float32 and r.wav.shape == (r.mel_len * 256,)
torch.manual_seed(0)
model = VTTS(n_vocab=16, n_audiotype=2, hidden=32, encoder_layers=1, decoder_layers=1,
             d_inner=64, max_mel_len=32, n_mels=16, vfe_layers=1, cell_hw=(24, 30),
             dtype=torch.bfloat16)
state = TrainState(model, NoamAdam(model.parameters(), warmup_steps=5), torch.Generator())
batch = {"audiotypes": torch.zeros(2, dtype=torch.int32),
         "texts": torch.ones(2, 4, dtype=torch.int32), "src_lens": torch.full((2,), 4),
         "image_cells": torch.rand(2, 4, 24, 30), "energies": torch.zeros(2, 4),
         "durations": torch.full((2, 4), 8), "mels": torch.randn(2, 32, 16)}
losses = train_step(state, batch)
assert all(np.isfinite(float(v)) for v in losses.values())
assert all(p.dtype == torch.float32 for p in model.parameters())
work = pathlib.Path(tempfile.mkdtemp())
(work / "wavs").mkdir()
t = np.arange(6000) / 22050
write_wav(work / "wavs" / "c.wav", (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), 22050)
main(["train-vocoder", str(work / "wavs"), str(work / "voc"), "--steps", "1", "--batch-size",
      "1", "--segment-size", "2048", "--bf16", "--device", "cpu"])
assert (work / "voc" / "1" / "generator.npz").exists()
shutil.rmtree(work)     # a full-state checkpoint of the full-width GAN
# bf16 HiFi-GAN V1: its stages at C 256 / 128 take the conv chain, at C 64
# the unit design, at C 32 the one-pass kernel, at the served mel length and
# without one; a mel of 8 frames is too short for either tile design
for vocoder, mrf, onepass, unit, blocks in (("HiFi-GAN", 2, 1, 1, 0), ("iSTFTNet-mel", 1, 0, 0, 0),
                                            ("Vocos", 0, 0, 0, 8)):
    model16, gen16, _ = chip_smoke.icassp_bf16("cpu", vocoder)
    assert model16.dtype == gen16.dtype == torch.bfloat16
    want = {"flash_mha": 10, "convnext_block": blocks, "convnext_trunk": 0, "mrf_stage": mrf,
            "mrf_stage_onepass": onepass, "mrf_stage_unit": unit, "conv1d_tc": 0}
    assert chip_smoke.per_call_launches(model16, gen16) == want
    assert chip_smoke.per_call_launches(model16, gen16, (16, 1000)) == want
    short = chip_smoke.per_call_launches(model16, gen16, (1, 8))
    assert short["mrf_stage"] == mrf + onepass + unit and short["mrf_stage_unit"] == 0
"""


# `cli export` of the demo checkpoint for the CPU, `cli serve --exported`
# answering one HTTP request from it, and two CPU replicas of the demo models
# through `parallel.make_sharded_synth`
EXPORT = """
import json, pathlib, tempfile, threading, time, urllib.request
import numpy as np, torch
torch.set_num_threads(2)
import visual_onoma_to_wave_tpu_torch.serve as serve
from visual_onoma_to_wave_tpu_torch.cli import main
from visual_onoma_to_wave_tpu_torch.parallel import make_sharded_synth
from visual_onoma_to_wave_tpu_torch.config import load_config
from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer
d, out = "examples/checkpoints/demo", pathlib.Path(tempfile.mkdtemp()) / "artifact"
main(["export", d + "/config.json", "--acoustic", d + "/torch/acoustic.npz", "--vocoder",
      d + "/torch/vocoder.npz", "--out", str(out), "--max-batch", "2", "--text-lens", "4",
      "--devices", "cpu"])
assert json.loads((out / "manifest.json").read_text())["devices"] == ["cpu"]
servers = []
class Once(serve.BatchingServer):
    def serve_forever(self):
        servers.append(self)
        self.start()
serve.BatchingServer = Once
main(["serve", "--exported", str(out), "--device", "cpu", "--port", "0"])
body = json.dumps({"text": "パン", "audiotype": "drum"}).encode()
req = urllib.request.Request(f"http://127.0.0.1:{servers[0].port}/v1/synthesize", data=body,
                             headers={"Content-Type": "application/json"})
with urllib.request.urlopen(req, timeout=120) as resp:
    assert json.loads(resp.read())["mel_frames"] >= 1
servers[0].stop()
synth = Synthesizer.from_checkpoint(load_config(d + "/config.json"), d + "/torch/acoustic.npz",
                                    d + "/torch/vocoder.npz", device="cpu")
g = np.load(d + "/torch/golden.npz")
batch = {k: g[k] for k in ("audiotypes", "texts", "src_lens", "image_cells")}
wavs, lens = make_sharded_synth(synth.model, synth.vocoder, ["cpu", "cpu"])(
    batch, g["e_control"], g["d_control"])
assert np.array_equal(lens, g["mel_lens"]) and np.abs(wavs - g["wav"]).max() < 1e-5
import shutil
shutil.rmtree(out.parent)
"""


# what chip_smoke's phases and the profiler build, on the CPU (phase 3's
# models run on the golden inputs; the full-width models of phases 4, 6, 10,
# 11 and 14 are only built)
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
for vocoder in ("HiFi-GAN", "iSTFTNet-mel", "iSTFTNet", "MelGAN", "Vocos", "BigVGAN"):
    model, gen, batch = chip_smoke.icassp_b16("cpu", vocoder)
    assert batch["image_cells"].shape == (16, 8, 24, 102)
    launches[vocoder] = chip_smoke.per_call_launches(model, gen)
assert chip_smoke.convnext_blocks(gen) == 0 and type(gen).__name__ == "BigVGANGenerator"
assert [launches[v]["mrf_stage"] for v in launches] == [4, 1, 2, 0, 0, 0], launches
assert [launches[v]["convnext_block"] for v in launches] == [0, 0, 0, 0, 8, 0], launches
assert set(chip_smoke.launch_counts()) == {"flash_mha", "convnext_block", "convnext_trunk",
                                           "mel_frontend", "mrf_stage", "mrf_stage_onepass",
                                           "mrf_stage_unit", "mrf_stage_amp", "amp_act",
                                           "conv1d_tc"}
assert [launches[v]["conv1d_tc"] for v in launches] == [25] * 6, launches
assert [launches[v]["mrf_stage_onepass"] for v in launches] == [0] * 6, launches
assert [launches[v]["mrf_stage_unit"] for v in launches] == [0] * 6, launches
assert [launches[v].get("mrf_stage_amp", 0) for v in launches] == [0, 0, 0, 0, 0, 4], launches
assert [launches[v].get("amp_act", 0) for v in launches] == [0, 0, 0, 0, 0, 4 * 21 + 1]
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


# the HTTP servers of phases 12 and 16 render glyphs (PIL): only JAX and its
# package are blocked
SMOKE_SERVED = """
import torch
import chip_smoke
out = chip_smoke.phase_served(torch.device("cpu"), "cpu")
assert out["stats"]["batches"] >= 1 and out["stats"]["requests"] == 4
out = chip_smoke.phase_demo_server(torch.device("cpu"), "cpu")
assert len(out["answered"]) == 4
"""


# the surface of the sixteenth slice: converters, doctor, a checkpoint served
# through --restore-step, griffin_lim, the sample figure, two CPU devices
SURFACE = """
import json, pathlib, shutil, tempfile, numpy as np, torch
torch.set_num_threads(1)
from visual_onoma_to_wave_tpu_torch.cli import main
from visual_onoma_to_wave_tpu_torch.config import DatasetMetadata, load_config
from visual_onoma_to_wave_tpu_torch.models.hifigan import HiFiGANGenerator
from visual_onoma_to_wave_tpu_torch.models.melgan import MelGANGenerator
from visual_onoma_to_wave_tpu_torch.models.vtts import VTTS
from visual_onoma_to_wave_tpu_torch.synthesis import Synthesizer
work = pathlib.Path(tempfile.mkdtemp())
demo = pathlib.Path("examples/checkpoints/demo")
cfg = json.loads((demo / "config.json").read_text())
cfg["path"].update(preprocessed=str(demo / "preprocessed"), ckpt=str(work / "ckpt"))
(work / "config.json").write_text(json.dumps(cfg))
config = load_config(work / "config.json")
# reference checkpoints from the port's modules (reference layout)
sd = VTTS.from_config(config, DatasetMetadata.load(config.path.preprocessed), n_vocab=12).state_dict()
torch.save({"model": {"module." + k: v for k, v in sd.items()}}, work / "a.pth.tar")
torch.save({"generator": HiFiGANGenerator(upsample_initial_channel=8).state_dict()},
           work / "h.pth.tar")
torch.save({"model": MelGANGenerator(ngf=8).state_dict()}, work / "m.pth.tar")
main(["convert-acoustic", str(work / "a.pth.tar"), str(work / "a.npz")])
main(["convert-vocoder", str(work / "h.pth.tar"), str(work / "h.npz")])
main(["convert-vocoder", str(work / "m.pth.tar"), str(work / "m.npz"), "--kind", "MelGAN"])
# a training checkpoint at step 5 holding the demo acoustic model
(work / "ckpt" / "5").mkdir(parents=True)
shutil.copy(demo / "torch" / "acoustic.npz", work / "ckpt" / "5" / "acoustic.npz")
np.savez(work / "ckpt" / "5" / "train_state.npz", step=np.array(5))
main(["synthesize", str(work / "config.json"), "--restore-step", "-1", "--vocoder",
      str(demo / "torch" / "vocoder.npz"), "--text", "パン", "--audiotype", "drum",
      "--out", str(work / "out.wav"), "--device", "cpu"])
assert (work / "out.wav").stat().st_size > 44
synth = Synthesizer.from_checkpoint(config, vocoder=str(demo / "torch" / "vocoder.npz"),
                                    device="cpu", devices=["cpu", "cpu"])
assert len(synth.synthesize_batch(["パン", "ドン", "パパ"], ["drum"] * 3)) == 3
from visual_onoma_to_wave_tpu_torch.data.features import extract_features
logmel, _, _ = extract_features([np.zeros(3000, np.float32)] * 3, [np.array([5, 7], np.int32)] * 3,
                                device="cpu", max_chars=48, devices=["cpu", "cpu"])
assert logmel.shape[0] == 4
from visual_onoma_to_wave_tpu_torch.ops.stft import griffin_lim, hann_window
wav = griffin_lim(torch.rand(513, 8), torch.from_numpy(hann_window(1024)), n_iters=2,
                  generator=torch.Generator().manual_seed(0))
assert wav.shape == (7 * 256,) and torch.isfinite(wav).all()
from visual_onoma_to_wave_tpu_torch.utils.plotting import expand_char_values, plot_mel
e = expand_char_values(np.array([0.1, 0.5]), np.array([3, 4]))
fig = plot_mel([(np.zeros((7, 80)), "x")], energies=[e], char_breaks=[[0, 3, 7]],
               energy_ylim=(0, 1), input_image=np.zeros((8, 16), np.uint8))
assert fig.size == (800, 360)
# doctor on a tiny corpus the parent built (formatted and preprocessed)
for stage in ("formatted", "preprocessed"):
    try:
        main(["doctor", CORPUS, "--stage", stage])
    except SystemExit as exc:
        assert exc.code == 1, exc.code
"""


def write_bigvgan_demo(work: pathlib.Path) -> None:
    """The demo config with a tiny BigVGAN as its vocoder, random weights for
    it in the flax layout (`bigvgan.npz`) and three batch rows, under `work`."""
    import json

    import jax
    import jax.numpy as jnp
    import numpy as np

    from test_torch_layers import init_random
    from visual_onoma_to_wave_tpu.models.vocoder import get_vocoder
    from visual_onoma_to_wave_tpu_torch.bridge import save_npz

    kwargs = {"upsample_initial_channel": 16, "resblock_kernel_sizes": [3],
              "resblock_dilations": [[1, 2]]}
    cfg = json.loads((ROOT / "examples/checkpoints/demo/config.json").read_text())
    cfg["model"].update(vocoder_model="BigVGAN", vocoder_kwargs=kwargs)
    (work / "config.json").write_text(json.dumps(cfg))
    gen = get_vocoder("BigVGAN", **{k: tuple(map(tuple, v)) if k == "resblock_dilations"
                                    else tuple(v) if isinstance(v, list) else v
                                    for k, v in kwargs.items()})
    variables = init_random(gen, np.random.default_rng(0), jnp.zeros((1, 4, 80)), scale=0.05)
    save_npz(work / "bigvgan.npz", jax.tree.map(np.asarray, variables))
    (work / "rows.txt").write_text("パン\tdrum\nバウバウ\tbell\t1.2\nclip|bell|24||チパ\n",
                                   encoding="utf-8")


def run_blocked(blocked, code: str) -> subprocess.CompletedProcess:
    """Run `code` in a fresh interpreter whose imports of `blocked` (and their
    submodules) raise ImportError. A finder on sys.meta_path does it rather
    than None entries in sys.modules, which scipy's array-API checks read as
    imported modules."""
    prelude = ("import importlib.abc, sys\n"
               f"BLOCKED = {tuple(blocked)!r}\n"
               "class Block(importlib.abc.MetaPathFinder):\n"
               "    def find_spec(self, name, path=None, target=None):\n"
               "        if name.split('.')[0] in BLOCKED:\n"
               "            raise ImportError(f'{name} is blocked')\n"
               "sys.meta_path.insert(0, Block())\n")
    epilogue = ("\nleaked = [m for m in sys.modules if m.split('.')[0] in BLOCKED]\n"
                "assert not leaked, leaked\n")
    return subprocess.run([sys.executable, "-c", prelude + code + epilogue], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("blocked,code", [
    (NO_JAX + ("yaml", "PIL"), CORE),
    (NO_JAX + ("yaml",), SERVED),
    (NO_JAX + ("yaml",), PREPROCESS),
    (NO_JAX + ("yaml", "PIL"), SMOKE),
    (NO_JAX + ("yaml",), SMOKE_SERVED),
    (NO_JAX + ("yaml",), TRAIN),
    (NO_JAX + ("yaml",), TOOL),
    (NO_JAX + ("yaml",), VOCODE),
    (NO_JAX + ("yaml",), DEMO),
    (NO_JAX + ("yaml",), GATE),
    (NO_JAX + ("yaml",), VOCODER_TRAIN),
    (NO_JAX + ("yaml",), EXPORT),
    (NO_JAX + ("yaml",), BF16),
    (NO_JAX + ("yaml",), SURFACE),
], ids=["compute-core-torch-numpy-only", "served-path-without-jax",
        "preprocess-without-jax", "chip-smoke-without-the-jax-package",
        "chip-smoke-server-without-the-jax-package", "train-path-without-jax",
        "acoustic-floor-tool-without-jax", "synthesize-batch-bigvgan-without-jax",
        "cli-demo-without-jax", "quality-gate-scoring-without-jax",
        "train-vocoder-and-longrun-tool-without-jax", "export-and-serve-exported-without-jax",
        "bf16-served-and-training-without-jax", "slice-16-surface-without-jax"])
def test_port_imports_without(blocked, code, tmp_path):
    if "CORPUS" in code:
        from benchmarks.bench_preprocess import build_corpus

        cfg = build_corpus(tmp_path, 6, n_labels=1)
        cfg.save(tmp_path / "config.json")
        code = code.replace("CORPUS", repr(str(tmp_path / "config.json")))
    if "BIGVGAN_DEMO" in code:
        write_bigvgan_demo(tmp_path)
        code = code.replace("BIGVGAN_DEMO", repr(str(tmp_path)))
    proc = run_blocked(blocked, code)
    assert proc.returncode == 0, proc.stderr[-3000:]


def test_no_jax_import_in_port_sources():
    assert all((PORT / name).exists() for name in SCANNED)
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), *SCRIPTS]
                 if pattern.search(p.read_text(encoding="utf-8"))]
    assert not offenders


def test_no_jax_package_import_in_scripts():
    """The scripts and every port module (the acceptance check's grep:
    `^\\s*(from|import) visual_onoma_to_wave_tpu(\\.|\\s|$)`)."""
    assert all((PORT / name).exists() for name in SCANNED)
    pattern = re.compile(rf"^\s*(import|from)\s+{JAX_PACKAGE}(\.|\s|$)", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"), *SCRIPTS]
                 if pattern.search(p.read_text(encoding="utf-8"))]
    assert not offenders

