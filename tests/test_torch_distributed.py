"""Data parallelism of the port over processes (`parallel/`), on the CPU.

Each spawning test starts a 2-process gloo group (tests/torch_distributed_worker.py)
and holds it to the same work done in this process alone on the global
batch, as JAX's data-parallel tests hold a sharded program to one device
(tests/test_distributed_training.py, tests/test_vocoder_training.py::
test_gan_step_data_parallel_equals_single_device):

- the acoustic train step, with dropout on and halves of unequal valid
  length: losses within 1e-6 (relative, and absolute below 1), the
  BatchNorms' running statistics within 1e-6 after one step and equal on
  both processes after three, and after 3 steps every parameter within 1e-6
  where the gradient is resolved in every step (at least 1e-2 of its leaf's RMS, in a
  leaf whose RMS is at least 1e-4 of the whole gradient's: Adam's first
  update is lr x sign(g), so gradients at roundoff size, such as the key
  projection's bias and the biases in front of a BatchNorm, move by +-lr
  on either side);
- the GAN step: losses within 1e-5 relative, the generator and its EMA
  within 1e-4 relative / 1e-6 absolute (JAX's test's bounds), one
  checkpoint written;
- the acoustic `Trainer` end to end: the same losses (1e-5) on both
  processes and alone, one checkpoint writer, resume from it.

- partitioned loading (`ProcessLoader.epoch(local_slice=)`): each
  process's rows, loaded alone and padded to the plan's shapes, equal its
  slice of the full batch bit for bit, and the data-parallel step fed by
  them equals the step fed by the sliced full batch bit for bit (losses
  and every parameter and statistic); a batch that does not divide raises
  JAX's error.

`make_sharded_synth` over two CPU replicas equals one (no processes).
Every spawn has its own time limit and is retried once on a gloo bring-up
error, as JAX's `_spawn_cluster` does.
"""
from __future__ import annotations

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_distributed_worker.py"
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(0, str(REPO / "tools"))

import torch_distributed_worker as worker  # noqa: E402

# bring-up failures of an oversubscribed host, not of the code: retried once
_INFRA_ERRORS = ("Connection refused", "Connection reset", "Address already in use",
                 "Timed out", "timed out")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(mode: str, tmp_path: pathlib.Path, *extra, n_proc: int = 2, timeout: float = 240,
          retries: int = 1) -> list[dict]:
    """The worker in n_proc processes; each process's result as a dict."""
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    for attempt in range(retries + 1):
        port = _free_port()
        outs = [tmp_path / f"{mode}_{rank}.npz" for rank in range(n_proc)]
        procs = [subprocess.Popen([sys.executable, str(WORKER), mode, str(rank), str(n_proc),
                                   str(port), str(out), *map(str, extra)], env=env,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for rank, out in enumerate(outs)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                logs.append(p.communicate()[0] + "\nTimed out")
        if all(p.returncode == 0 for p in procs):
            return [dict(np.load(o)) for o in outs]
        infra = any(e in log for log in logs for e in _INFRA_ERRORS)
        if not (infra and attempt < retries):
            for p, log in zip(procs, logs):
                assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    raise AssertionError("unreachable")


def assert_losses(got: dict, want: dict, keys, rtol: float) -> None:
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=rtol, err_msg=k)


def test_acoustic_step_over_two_processes_equals_one(tmp_path):
    ref = worker.run_step(1)
    results = spawn("step", tmp_path)
    loss_keys = [k for k in ref if k.startswith("loss")]
    assert len(loss_keys) == 3 * 7          # 6 losses and the grad norm, 3 steps
    for r in results:
        assert_losses(r, ref, loss_keys, 1e-6)
        np.testing.assert_array_equal(r["gathered_src_lens"], worker.global_batch()["src_lens"])
    # the gradient each process applies is the global one
    for k in ref:
        if k.startswith("grad"):
            np.testing.assert_allclose(results[1][k], results[0][k], rtol=0, atol=0, err_msg=k)
    rms = [np.sqrt(np.mean(np.concatenate([v.ravel() ** 2 for k, v in ref.items()
                                            if k.startswith(f"grad{i}/")])))
           for i in range(3)]
    for k in (k for k in ref if k.startswith("state/")):
        name = k[len("state/"):]
        grads = [ref.get(f"grad{i}/{name}") for i in range(3)]
        np.testing.assert_array_equal(results[0][k], results[1][k], err_msg=k)
        if grads[0] is None:     # a buffer: after one step (later, the drifting biases move it)
            for r in results:
                if "running" in name:
                    np.testing.assert_allclose(r[f"stats0/{name}"], ref[f"stats0/{name}"],
                                               rtol=0, atol=1e-6, err_msg=name)
            continue
        resolved = np.all([(np.abs(g) >= 1e-2 * np.sqrt(np.mean(g * g)))
                           & (np.sqrt(np.mean(g * g)) >= 1e-4 * r)
                           for g, r in zip(grads, rms)], 0)
        for r in results:
            np.testing.assert_allclose(r[k][resolved], ref[k][resolved], rtol=0, atol=1e-6,
                                       err_msg=k)


def test_gan_step_data_parallel_equals_single_process(tmp_path):
    ref = worker.run_gan(1, str(tmp_path / "one"))
    results = spawn("gan", tmp_path, tmp_path / "two")
    loss_keys = [k for k in ref if k.startswith("loss")]
    for r in results:
        assert_losses(r, ref, loss_keys, 1e-5)
        assert int(r["step"]) == 3
        for k in ref:
            if k.startswith(("gen/", "ema/")):
                np.testing.assert_allclose(r[k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert sorted(p.name for p in (tmp_path / "two").iterdir()) == ["3"]
    assert (tmp_path / "two" / "3" / "generator.npz").exists()


@pytest.fixture(scope="module")
def floor_corpus(tmp_path_factory):
    """The floor tool's synthetic corpus at 2 x 20 clips, preprocessed on the
    CPU, with a config of batch 4, checkpoints every 2 steps."""
    from acoustic_floor_torch import build_floor_corpus, floor_config

    work = tmp_path_factory.mktemp("corpus")
    cfg, raw = floor_config(work, n_per_class=20, steps=4, width="small", batch=4)
    build_floor_corpus(cfg, raw, "cpu")
    data = json.loads((work / "cfg.json").read_text())
    data["train"]["step"].update(save_step=2, log_step=1)
    (work / "cfg.json").write_text(json.dumps(data))
    return work / "cfg.json"


def test_trainer_over_two_processes_one_writer_and_resume(floor_corpus, tmp_path):
    ref = worker.run_trainer(1, str(floor_corpus), str(tmp_path / "one"))
    results = spawn("trainer", tmp_path, floor_corpus, tmp_path / "two")
    assert len(ref["losses"]) == 4 and int(ref["restored"]) == 2
    for r in results:
        assert int(r["restored"]) == 2
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["val_total"], ref["val_total"], rtol=1e-5)
    # process 0 writes every checkpoint, process 1 none
    assert list(results[0]["saves"]) == list(ref["saves"]) and len(ref["saves"]) >= 2
    assert len(results[1]["saves"]) == 0
    steps = sorted(int(p.name) for p in (tmp_path / "two" / "ckpt").iterdir() if p.is_dir())
    assert steps == [2, 4]
    for k in (k for k in ref if k.startswith("state/")):
        np.testing.assert_array_equal(results[0][k], results[1][k], err_msg=k)


def test_partitioned_loading_equals_the_sliced_full_batch(floor_corpus, tmp_path):
    results = spawn("partition", tmp_path, floor_corpus, tmp_path / "run")
    for rank, r in enumerate(results):
        keys = [k[len("local/batch/"):] for k in r if k.startswith("local/batch/")]
        assert "mels" in keys and "image_cells" in keys
        for k in keys:
            a, b = r[f"local/batch/{k}"], r[f"full/batch/{k}"]
            assert a.dtype == b.dtype and np.array_equal(a, b), (rank, k)
        assert r["local/batch/texts"].shape[0] == 2           # batch 4 over 2 processes
        for k in (k for k in r if k.startswith("local/loss/") or k.startswith("local/state/")):
            np.testing.assert_array_equal(r[k], r["full/" + k[len("local/"):]], err_msg=k)
    # the processes agree on the padded shapes and hold different rows
    a, b = results
    for k in ("mels", "texts", "image_cells"):
        assert a[f"local/batch/{k}"].shape == b[f"local/batch/{k}"].shape
    assert not np.array_equal(a["local/batch/mels"], b["local/batch/mels"])


def test_local_slice_refuses_a_batch_that_does_not_divide(floor_corpus):
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.data.dataset import OnomaDataset
    from visual_onoma_to_wave_tpu_torch.data.loader import ProcessLoader

    ds = OnomaDataset("train.txt", load_config(floor_corpus), sort=True, drop_last=True)
    with ProcessLoader(ds, "train.txt", num_workers=0) as loader:
        with pytest.raises(ValueError, match="not divisible by 3 processes"):
            next(iter(loader.epoch(group_size=4, seed=1, local_slice=(0, 3))))


def test_sharded_synth_over_two_cpu_replicas_equals_one():
    from visual_onoma_to_wave_tpu_torch.models.hifigan import HiFiGANGenerator
    from visual_onoma_to_wave_tpu_torch.models.vtts import VTTS
    from visual_onoma_to_wave_tpu_torch.parallel import make_sharded_synth

    torch.manual_seed(0)
    model = VTTS(**worker.TINY, use_image=True, cell_hw=(8, 16)).eval()
    gen = HiFiGANGenerator(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                           upsample_initial_channel=32, n_mels=worker.N_MELS).eval()
    b = worker.global_batch()
    batch = {k: b[k] for k in ("audiotypes", "texts", "src_lens", "image_cells")}
    e = np.array([1.0, 0.8, 1.2, 1.0], np.float32)
    one = make_sharded_synth(model, gen, ["cpu"])(batch, e_control=e, d_control=1.1)
    two = make_sharded_synth(model, gen, ["cpu", "cpu"])(batch, e_control=e, d_control=1.1)
    np.testing.assert_array_equal(two[1], one[1])
    np.testing.assert_allclose(two[0], one[0], rtol=0, atol=1e-6)
    assert one[0].shape == (4, worker.T * 256) and np.isfinite(one[0]).all()
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_synth(model, gen, ["cpu"] * 3)(batch)
