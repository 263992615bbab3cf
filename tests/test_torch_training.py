"""The port's acoustic training against the JAX package's, on the CPU.

The tiny model of tests/test_training.py (hidden 32, one encoder and one
decoder layer), with and without image cells, gets the same parameters on
both sides through the weight bridge; the batch comes from a numpy seed.
"Dropout 0" means every dropout rate 0 while the model stays in training
mode (JAX: deterministic=False), so BatchNorm runs on batch statistics and
attention takes its plain path with autograd. Both PostNets fix their rate
at 0.5, so the JAX side builds its PostNet with rate 0 here and the port's
PostNet gets `dropout.p = 0`.

Tolerances, fixed before the runs: loss terms 1e-5; gradients 1e-5 of their
leaf's norm (a bias whose exact gradient is 0 -- the key projection's, which
the softmax cancels, and a convolution's in front of a BatchNorm, which the
normalisation cancels -- is held at 1e-5 of its layer's kernel gradient,
since both sides give it roundoff only); BatchNorm statistics, Adam's
moments and parameters 1e-6. Adam's step divides the first moment by the
root of the second elementwise, so an element whose gradient is at roundoff
size takes a direction set by that roundoff (its first update is lr * the
sign of its gradient) on either side; parameters are therefore compared at
the elements whose gradient is at least 1e-2 of its leaf's RMS, one step at
a time from the same state.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import visual_onoma_to_wave_tpu.models.vtts as jvtts
from visual_onoma_to_wave_tpu.config import Config as JConfig
from visual_onoma_to_wave_tpu.models.layers import PostNet as JPostNet
from visual_onoma_to_wave_tpu.training import (
    create_train_state,
    make_optimizer,
    make_train_step,
    noam_schedule,
)
from visual_onoma_to_wave_tpu.training.loss import fastspeech2_loss as jax_loss
from visual_onoma_to_wave_tpu_torch.bridge import flatten_tree, vtts_state_dict, vtts_tree
from visual_onoma_to_wave_tpu_torch.config import load_config
from visual_onoma_to_wave_tpu_torch.models.layers import (
    BatchNorm1d,
    Dropout,
    set_dropout_generator,
)
from visual_onoma_to_wave_tpu_torch.models.vtts import VTTS
from visual_onoma_to_wave_tpu_torch.training.loss import fastspeech2_loss
from visual_onoma_to_wave_tpu_torch.training.schedule import NoamAdam, noam_lr
from visual_onoma_to_wave_tpu_torch.training.train_state import TrainState, train_step
from visual_onoma_to_wave_tpu_torch.utils.checkpoint import CheckpointManager

B, C, T, N_MELS = 4, 4, 32, 16
TINY = dict(n_vocab=10, n_audiotype=3, hidden=32, encoder_layers=1, decoder_layers=1,
            n_head=2, d_inner=64, ffn_kernel=(3, 1), max_seq_len=64, max_mel_len=T,
            n_mels=N_MELS, vfe_layers=1, is_energy=True, is_kurtosis=False,
            energy_stats=(-2.0, 2.0, 0.0, 1.0))
NO_DROPOUT = dict(encoder_dropout=0.0, decoder_dropout=0.0, vp_dropout=0.0)
OPT = dict(init_lr=1e-2, warmup_steps=10, grad_clip=1.0)
# exactly-zero gradients: the key bias (softmax) and convolutions feeding a BatchNorm
ZERO_GRAD = ("slf_attn/w_ks/bias", "vfe/conv_0/bias") + tuple(
    f"postnet/conv_{i}/bias" for i in range(5))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny tensors gain nothing from intra-op threads, and beside the other
    test workers they only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny_batch(use_image: bool, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    lens = np.array([4, 3, 4, 2], np.int32)
    texts = rng.integers(1, 10, (B, C)).astype(np.int32)
    texts[np.arange(C)[None, :] >= lens[:, None]] = 0
    b = {"audiotypes": rng.integers(0, 3, B).astype(np.int32), "texts": texts,
         "src_lens": lens, "mels": rng.standard_normal((B, T, N_MELS)).astype(np.float32),
         "energies": rng.standard_normal((B, C)).astype(np.float32),
         "durations": np.array([[8, 8, 8, 8], [10, 6, 9, 0], [5, 5, 5, 5], [7, 9, 0, 0]],
                               np.int32)}
    if use_image:
        b["image_cells"] = rng.uniform(0, 1, (B, C, 8, 16)).astype(np.float32)
    return b


@pytest.fixture
def no_postnet_dropout(monkeypatch):
    """The JAX VTTS builds its PostNet (rate fixed at 0.5) at every trace:
    for the test's duration it builds it with rate 0."""
    monkeypatch.setattr(jvtts, "PostNet", functools.partial(JPostNet, dropout=0.0))


def jax_setup(use_image: bool, tx=None):
    """(JAX model without dropout, batch, initial state, tx); the caller's
    test takes the `no_postnet_dropout` fixture."""
    jm = jvtts.VTTS(**TINY, **NO_DROPOUT)
    b = {k: jnp.asarray(v) for k, v in tiny_batch(use_image).items()}
    tx = tx or make_optimizer(**OPT)
    state = create_train_state(jm, tx, jax.random.PRNGKey(0), b, use_image=use_image)
    return jm, b, state, tx


def port_model(use_image: bool, variables: dict) -> VTTS:
    m = VTTS(**TINY, use_image=use_image, cell_hw=(8, 16), **NO_DROPOUT)
    m.postnet.dropout.p = 0.0
    m.load_state_dict(vtts_state_dict(jax.tree.map(np.asarray, variables)))
    return m


def torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def jax_loss_and_grads(jm, params, batch_stats, b, use_image):
    def loss_fn(params):
        out, mut = jm.apply({"params": params, "batch_stats": batch_stats},
                            audiotypes=b["audiotypes"], texts=b["texts"], src_lens=b["src_lens"],
                            image_cells=b.get("image_cells"), energy_targets=b["energies"],
                            duration_targets=b["durations"], use_image=use_image,
                            deterministic=False, max_mel_len=T, mutable=["batch_stats"])
        losses = jax_loss(out, b)
        return losses["total_loss"], (losses, mut["batch_stats"])
    grads, (losses, new_bs) = jax.grad(loss_fn, has_aux=True)(params)
    return grads, losses, new_bs


def flat(tree) -> dict:
    return flatten_tree(jax.tree.map(np.asarray, tree))


def port_tree(model: VTTS, replace: dict | None = None) -> dict:
    """The model's state as a flat flax tree; `replace` swaps parameter
    tensors (grads, moments) in by name."""
    sd = dict(model.state_dict())
    sd.update(replace or {})
    return flatten_tree(vtts_tree(sd))


def well_resolved(grads: dict) -> dict:
    """Per leaf, the elements whose gradient is at least 1e-2 of the leaf's RMS."""
    return {k: np.abs(v) >= 1e-2 * np.sqrt(np.mean(v * v)) for k, v in grads.items()}


@pytest.mark.parametrize("use_image", [False, True], ids=["tokens", "image"])
def test_one_step_parity_without_dropout(use_image, no_postnet_dropout):
    jm, b, state, _ = jax_setup(use_image)
    grads, jl, jbs = jax_loss_and_grads(jm, state.params, state.batch_stats, b, use_image)
    model = port_model(use_image, {"params": state.params, "batch_stats": state.batch_stats})
    model.train()
    tb = torch_batch(b)
    out = model(tb["audiotypes"], tb["texts"], tb["src_lens"], image_cells=tb.get("image_cells"),
                energy_targets=tb["energies"], duration_targets=tb["durations"], max_mel_len=T)
    tl = fastspeech2_loss(out, tb)
    for k in jl:
        assert abs(float(tl[k]) - float(jl[k])) <= 1e-5, (k, float(tl[k]), float(jl[k]))
    tl["total_loss"].backward()
    gt = port_tree(model, {n: p.grad for n, p in model.named_parameters()})
    gj = flat({"params": grads})
    assert gt.keys() - {k for k in gt if k.startswith("batch_stats")} == gj.keys()
    for k, g in gj.items():
        scale = np.linalg.norm(g)
        if k.endswith(ZERO_GRAD):
            scale = max(scale, np.linalg.norm(gj[k.removesuffix("bias") + "kernel"]))
        assert np.abs(gt[k] - g).max() <= 1e-5 * scale, (k, np.abs(gt[k] - g).max(), scale)
    # trap: flax's BatchNorm moves the running variance to the BIASED batch variance
    bst, bsj = port_tree(model), flat({"batch_stats": jbs})
    assert bsj and all(np.abs(bst[k] - v).max() <= 1e-6 for k, v in bsj.items())


def _adam_state(opt_state):
    """optax.chain(clip, adam) state -> the ScaleByAdamState."""
    return opt_state[1][0]


def test_three_optax_steps(no_postnet_dropout):
    """Free-running: the loss terms and grad norms of 3 steps, then Adam's
    moments, against optax. From the same state at each step: the updated
    parameters (well-resolved elements), BatchNorm statistics and moments."""
    jm, b, state, tx = jax_setup(True)
    step_fn = make_train_step(jm, tx, use_image=True)
    model = port_model(True, {"params": state.params, "batch_stats": state.batch_stats})
    opt = NoamAdam(model.parameters(), **OPT)
    ts = TrainState(model, opt, torch.Generator().manual_seed(0))
    names = [n for n, _ in model.named_parameters()]
    tb = torch_batch(b)
    js = state
    for _ in range(3):
        js, jl = step_fn(js, b, jax.random.PRNGKey(1))
        tl = train_step(ts, tb)
        for k in jl:
            assert abs(float(tl[k]) - float(jl[k])) <= 1e-5 * max(1.0, abs(float(jl[k]))), k
    arrays = opt.state_arrays(names)
    adam = _adam_state(js.opt_state)
    for port_key, moments in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        got = port_tree(model, {n: arrays[f"{port_key}/{n}"] for n in names})
        for k, v in flat({"params": moments}).items():
            assert np.abs(got[k] - v).max() <= 1e-6, (port_key, k)
    assert int(adam.count) == opt.count == 3

    # from the same state at each step (the JAX step consumed `state`)
    js = jax_setup(True, tx=tx)[2]
    for _ in range(3):
        model = port_model(True, {"params": js.params, "batch_stats": js.batch_stats})
        opt = NoamAdam(model.parameters(), **OPT)
        adam = _adam_state(js.opt_state)
        if int(adam.count):
            loaded = {"count": torch.tensor(int(adam.count)), "mini_step": torch.tensor(0)}
            for key, moments in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
                sd = vtts_state_dict({"params": jax.tree.map(np.asarray, moments),
                                      "batch_stats": jax.tree.map(np.asarray, js.batch_stats)})
                loaded.update({f"{key}/{n}": sd[n] for n in names})
                loaded.update({f"adam_step/{n}": torch.tensor(float(adam.count)) for n in names})
            opt.load_state_arrays(names, loaded)
        grads, _, _ = jax_loss_and_grads(jm, js.params, js.batch_stats, b, True)
        js, _ = step_fn(js, b, jax.random.PRNGKey(1))
        train_step(TrainState(model, opt, torch.Generator()), tb)
        got, want = port_tree(model), flat({"params": js.params, "batch_stats": js.batch_stats})
        mask = well_resolved(flat({"params": grads}))
        for k, v in want.items():
            if k.startswith("batch_stats"):
                assert np.abs(got[k] - v).max() <= 1e-6, k
            elif not k.endswith(ZERO_GRAD):
                assert np.abs(got[k] - v)[mask[k]].max(initial=0.0) <= 1e-6, k
        arrays = opt.state_arrays(names)
        adam = _adam_state(js.opt_state)
        got = port_tree(model, {n: arrays[f"exp_avg/{n}"] for n in names})
        assert all(np.abs(got[k] - v).max() <= 1e-6
                   for k, v in flat({"params": adam.mu}).items())


def _one_update(grads: dict, max_norm: float) -> tuple[NoamAdam, dict]:
    """One NoamAdam step of params at zero with `grads`, and optax's chain."""
    params = {k: torch.nn.Parameter(torch.zeros(v.shape)) for k, v in grads.items()}
    opt = NoamAdam(params.values(), grad_clip=max_norm)
    for k, p in params.items():
        p.grad = torch.from_numpy(grads[k].copy())
    opt.step()
    tx = make_optimizer(grad_clip=max_norm)
    jp = {k: jnp.zeros(v.shape) for k, v in grads.items()}
    updates, st = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, tx.init(jp), jp)
    return opt, {"params": params, "updates": updates, "mu": _adam_state(st).mu}


@pytest.mark.parametrize("max_norm", [0.5, 50.0], ids=["norm-above-max", "norm-below-max"])
def test_clip_by_global_norm(max_norm):
    rng = np.random.default_rng(1)
    grads = {"a": rng.normal(size=(7, 3)).astype(np.float32),
             "b": rng.normal(size=(11,)).astype(np.float32)}
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in grads.values()))
    assert (norm > max_norm) == (max_norm == 0.5)
    opt, ref = _one_update(grads, max_norm)
    clipped, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
    for k, p in ref["params"].items():
        # the gradient Adam saw is optax's clipped one (g / norm * max above max)
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(clipped[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(opt.adam.state[p]["exp_avg"].numpy(), np.asarray(ref["mu"][k]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref["updates"][k]),
                                   rtol=1e-5, atol=1e-10)


@pytest.mark.parametrize("count", [0, 1, 3998, 3999, 4000, 4001, 299999, 300000, 300001,
                                   400000, 500000, 600000])
def test_noam_schedule_matches_jax(count):
    """Steps 1, warmup and warmup + 1, and past each anneal (step = count + 1)."""
    want = float(noam_schedule(0.001, 4000, (300000, 400000, 500000), 0.3)(count))
    assert abs(noam_lr(count, 0.001, 4000) - want) <= 1e-6 * want


def test_lr_follows_applied_updates_under_accumulation():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = NoamAdam([p], init_lr=1.0, warmup_steps=10, grad_acc_steps=3)
    for i in range(9):
        p.grad = torch.ones(3)
        moved = opt.step()
        assert moved == (i % 3 == 2) and opt.count == (i + 1) // 3
        if moved:
            assert opt.adam.param_groups[0]["lr"] == noam_lr(opt.count - 1, 1.0, 10)


def test_accumulation_matches_multisteps():
    """grad_acc_step 2 against optax.MultiSteps over 4 mini-steps of random
    gradients: the parameters move only on every 2nd, by the same update."""
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 4), "b": (6,)}
    init = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = NoamAdam(params.values(), init_lr=1e-2, warmup_steps=3, grad_clip=1.0,
                   grad_acc_steps=2)
    tx = make_optimizer(init_lr=1e-2, warmup_steps=3, grad_clip=1.0, grad_acc_steps=2)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    st = tx.init(jp)
    for i in range(4):
        g = {k: rng.normal(scale=0.3 + i, size=s).astype(np.float32) for k, s in shapes.items()}
        before = {k: p.detach().clone() for k, p in params.items()}
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
        assert opt.step() == (i % 2 == 1)
        updates, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
            if i % 2 == 0:
                assert torch.equal(p.detach(), before[k])
        acc = {k: np.asarray(v) for k, v in st.acc_grads.items()}
        for a, k in zip(opt.acc, params):
            np.testing.assert_allclose(a.numpy(), acc[k], rtol=0, atol=1e-6)


def test_accumulated_model_steps_match_jax(no_postnet_dropout):
    """The tiny model with grad_acc_step 2, 2 mini-steps: losses and Adam's
    moments against make_optimizer(grad_acc_steps=2)."""
    tx = make_optimizer(**OPT, grad_acc_steps=2)
    jm, b, state, tx = jax_setup(False, tx=tx)
    step_fn = make_train_step(jm, tx, use_image=False)
    model = port_model(False, {"params": state.params, "batch_stats": state.batch_stats})
    opt = NoamAdam(model.parameters(), **OPT, grad_acc_steps=2)
    ts = TrainState(model, opt, torch.Generator())
    js, tb = state, torch_batch(b)
    for _ in range(2):
        js, jl = step_fn(js, b, jax.random.PRNGKey(1))
        tl = train_step(ts, tb)
        assert abs(float(tl["total_loss"]) - float(jl["total_loss"])) <= 1e-5 * float(
            jl["total_loss"])
    names = [n for n, _ in model.named_parameters()]
    arrays = opt.state_arrays(names)
    adam = js.opt_state.inner_opt_state[1][0]
    got = port_tree(model, {n: arrays[f"exp_avg/{n}"] for n in names})
    assert all(np.abs(got[k] - v).max() <= 1e-6 for k, v in flat({"params": adam.mu}).items())
    assert int(js.step) == ts.step == 2 and opt.count == int(adam.count) == 1


def test_tiny_overfit_loss_decreases():
    """tests/test_training.py::test_tiny_overfit_loss_decreases on the port:
    dropout on (the model's default rates), 60 steps, loss falls by 30%."""
    torch.manual_seed(0)
    model = VTTS(**TINY, use_image=False)
    ts = TrainState(model, NoamAdam(model.parameters(), **OPT), torch.Generator().manual_seed(42))
    tb = torch_batch(tiny_batch(False))
    losses = [float(train_step(ts, tb)["total_loss"]) for _ in range(60)]
    assert np.isfinite(losses[-1]) and losses[-1] < 0.7 * losses[0], (losses[0], losses[-1])


@pytest.mark.parametrize("acc", [1, 2], ids=["no-accumulation", "accumulate-2"])
def test_resume_is_bit_exact(tmp_path, acc):
    """Dropout on: 4 steps equal 2 steps, a checkpoint, a fresh model,
    optimizer and generator restored from it, and 2 more steps (with
    accumulation over 2 the checkpoint sits between two updates' halves
    when taken after an odd step: 3 + 1 then)."""
    batches = [torch_batch(tiny_batch(True, seed=s)) for s in range(4)]

    def fresh(seed):
        torch.manual_seed(seed)
        m = VTTS(**TINY, use_image=True, cell_hw=(8, 16))
        return TrainState(m, NoamAdam(m.parameters(), **OPT, grad_acc_steps=acc),
                          torch.Generator().manual_seed(7))

    whole = fresh(0)
    want = [train_step(whole, bt)["total_loss"] for bt in batches]
    split = 2 if acc == 1 else 3
    first = fresh(0)
    got = [train_step(first, bt)["total_loss"] for bt in batches[:split]]
    ckpt = CheckpointManager(tmp_path)
    ckpt.save(first)
    second = ckpt.restore(fresh(1), -1)
    assert second.step == split
    got += [train_step(second, bt)["total_loss"] for bt in batches[split:]]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for (n, a), b in zip(whole.model.state_dict().items(), second.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert whole.optimizer.count == second.optimizer.count


def test_checkpoints_keep_the_newest(tmp_path):
    model = VTTS(**TINY, use_image=False)
    ts = TrainState(model, NoamAdam(model.parameters()), torch.Generator())
    ckpt = CheckpointManager(tmp_path, max_to_keep=3)
    for step in (5, 10, 15, 20):
        ts.step = step
        ckpt.save(ts)
    assert ckpt.all_steps() == [10, 15, 20] and ckpt.latest_step() == 20


def test_dropout_draws_from_the_generator():
    x = torch.ones(64, 64)
    d = Dropout(0.5).train()
    d.generator = torch.Generator().manual_seed(3)
    a = d(x)
    torch.manual_seed(99)        # the global RNG plays no part
    d.generator = torch.Generator().manual_seed(3)
    assert torch.equal(a, d(x)) and set(a.unique().tolist()) == {0.0, 2.0}
    assert torch.equal(d.eval()(x), x)


def jax_dropout_calls(monkeypatch, use_image: bool) -> list[tuple[str, float]]:
    """(site, rate) of every dropout the JAX VTTS applies in one training
    forward of the tiny model, in order; a site is its module path without
    the `Dropout_k` leaf (`encoder/layer_0/slf_attn`)."""
    import flax.linen as nn

    calls, call = [], nn.Dropout.__call__

    def recording(self, inputs, *args, **kwargs):
        path, m = [], self.parent
        while isinstance(m, nn.Module) and m.name is not None:
            path.append(m.name)
            m = m.parent
        calls.append(("/".join(reversed(path)), self.rate))
        return call(self, inputs, *args, **kwargs)

    jm = jvtts.VTTS(**TINY)
    b = {k: jnp.asarray(v) for k, v in tiny_batch(use_image).items()}
    inputs = {k: b[k] for k in ("audiotypes", "texts", "src_lens")}
    if use_image:
        inputs["image_cells"] = b["image_cells"]
    v = jm.init(jax.random.PRNGKey(0), **inputs, use_image=use_image, deterministic=True)
    monkeypatch.setattr(nn.Dropout, "__call__", recording)
    jm.apply(v, **inputs, energy_targets=b["energies"], duration_targets=b["durations"],
             use_image=use_image, deterministic=False, max_mel_len=T, mutable=["batch_stats"],
             rngs={"dropout": jax.random.PRNGKey(1)})
    return calls


@pytest.mark.parametrize("use_image", [False, True], ids=["tokens", "image"])
def test_dropout_sites_and_rates_match_jax(use_image, monkeypatch):
    """In `.train()` the port applies dropout at JAX's sites, in JAX's order,
    at JAX's rates (FFT blocks 0.2, variance predictors 0.5, PostNet 0.5 at
    each of its five layers), drops that share of the elements (within five
    standard errors over all the calls at a rate) and scales the kept ones
    by 1/(1-p) exactly."""
    want = jax_dropout_calls(monkeypatch, use_image)
    model = VTTS(**TINY, use_image=use_image, cell_hw=(8, 16)).train()
    set_dropout_generator(model, torch.Generator().manual_seed(5))
    got, dropped = [], {}

    def record(name):
        def hook(mod, args, out):
            site = name.removesuffix(".dropout").replace("layer_stack.", "layer_")
            got.append((site.replace(".", "/"), mod.p))
            x = args[0]
            live = x != 0
            kept = live & (out != 0)
            assert torch.equal(out[kept], (x / (1.0 - mod.p))[kept]), name
            assert not out[~kept].any(), name
            n, k = dropped.get(mod.p, (0, 0))
            dropped[mod.p] = (n + int(live.sum()), k + int((live & ~kept).sum()))
        return hook

    for name, m in model.named_modules():
        if isinstance(m, Dropout):
            m.register_forward_hook(record(name))
    tb = torch_batch(tiny_batch(use_image))
    model(tb["audiotypes"], tb["texts"], tb["src_lens"], image_cells=tb.get("image_cells"),
          energy_targets=tb["energies"], duration_targets=tb["durations"], max_mel_len=T)
    assert got == want
    assert sorted(dropped) == [0.2, 0.5]
    for p, (n, k) in dropped.items():
        assert abs(k / n - p) <= 5.0 * np.sqrt(p * (1.0 - p) / n), (p, n, k)


def test_dropout_rates_from_the_config_match_jax():
    """At configs/icassp.yaml each port site takes the rate the JAX VTTS's
    `from_config` gives it (the PostNet's is fixed at the JAX module's
    default)."""
    from visual_onoma_to_wave_tpu.cli import load_config as jax_load_config

    jicassp = jvtts.VTTS.from_config(jax_load_config("configs/icassp.yaml"), None, n_vocab=12)
    want = {"encoder": jicassp.encoder_dropout, "decoder": jicassp.decoder_dropout,
            "variance_adaptor": jicassp.vp_dropout, "postnet": JPostNet.dropout}
    model = VTTS.from_config(load_config("configs/icassp.yaml"), None, n_vocab=12)
    rates = {(name.split(".")[0], m.p) for name, m in model.named_modules()
             if isinstance(m, Dropout)}
    assert rates == set(want.items())


def test_batchnorm_running_stats_are_flax():
    """momentum 0.9 on the flax side is torch's 0.1, and the running variance
    takes the biased batch variance."""
    import flax.linen as nn

    x = np.random.default_rng(4).normal(2.0, 3.0, (5, 7, 6)).astype(np.float32)   # (B, T, C)
    jbn = nn.BatchNorm(use_running_average=False, momentum=0.9)
    v = jbn.init(jax.random.PRNGKey(0), x)
    y, mut = jbn.apply(v, x, mutable=["batch_stats"])
    bn = BatchNorm1d(6).train()
    out = bn(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), mut["batch_stats"]["mean"], atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), mut["batch_stats"]["var"], atol=1e-6)


def test_initialisation_matches_flax():
    """Every leaf's mean and std at hidden 128 against flax's init (within
    four standard errors of the estimate), and the parameter count at
    configs/icassp.yaml equal to JAX's."""
    kw = dict(TINY, hidden=128, d_inner=256, energy_stats=(-1.0, 1.0, 0.0, 1.0))
    b = tiny_batch(True)
    jm = jvtts.VTTS(**kw)
    jv = flat(jm.init(jax.random.PRNGKey(0), **{k: jnp.asarray(b[k]) for k in
                                                ("audiotypes", "texts", "src_lens",
                                                 "image_cells")}, deterministic=True))
    torch.manual_seed(0)
    tv = port_tree(VTTS(**kw, use_image=True, cell_hw=(8, 16)))
    assert tv.keys() == jv.keys()
    for k, j in jv.items():
        t = tv[k]
        n, sd = j.size, float(np.std(j))
        if k.startswith("params/vfe") and n < 8:   # U(-0.08, 0.08), too few to estimate
            assert np.abs(t).max() <= 0.08 and np.abs(j).max() <= 0.08, k
            continue
        if sd == 0.0:
            assert np.array_equal(t, j), k          # zeros and ones
            continue
        se = 4.0 * sd / np.sqrt(n)
        assert abs(float(np.mean(t)) - float(np.mean(j))) <= 2 * se, k
        assert abs(float(np.std(t)) - sd) <= 4.0 * sd * np.sqrt(2.0 / n) + 0.02 * sd, k

    cfg = load_config("configs/icassp.yaml")
    icassp = VTTS.from_config(cfg, None, n_vocab=12)
    jicassp = jvtts.VTTS.from_config(JConfig(), None, n_vocab=12)
    shapes = jax.eval_shape(lambda: jicassp.init(
        jax.random.PRNGKey(0), audiotypes=jnp.zeros(2, jnp.int32),
        texts=jnp.zeros((2, 8), jnp.int32), src_lens=jnp.full((2,), 8),
        image_cells=jnp.zeros((2, 8, 24, 102)), deterministic=True))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in icassp.parameters()) == n_jax == 34_722_918


@pytest.mark.slow  # ~4 min: 400 steps of each package on the CPU
def test_side_by_side_loss_curve_without_dropout(tmp_path, monkeypatch):
    """400 steps of a 2-layer hidden-64 model on the port's synthetic corpus
    (2 x 14 clips, batch 16), every dropout rate 0, the same initial
    parameters and the same batches through JAX's train step and the port's:
    each 50-step mean of the total and mel losses within 1% of JAX's. The
    one-step tests hold a step to 1e-5; this holds the roundoff the two
    packages accumulate over many steps to the same curve (the run recorded
    in ROADMAP section C gave at most 0.62%)."""
    import json
    import pathlib

    from test_torch_dataset import preprocessed_corpus

    from visual_onoma_to_wave_tpu.cli import load_config as jax_load_config
    from visual_onoma_to_wave_tpu.config import DatasetMetadata as JaxMetadata
    from visual_onoma_to_wave_tpu.data.dataset import OnomaDataset as JaxDataset
    from visual_onoma_to_wave_tpu_torch.config import DatasetMetadata
    from visual_onoma_to_wave_tpu_torch.data.dataset import to_device

    torch.set_num_threads(4)
    monkeypatch.setattr(jvtts, "PostNet", functools.partial(JPostNet, dropout=0.0))
    path = pathlib.Path(preprocessed_corpus(tmp_path, n_per_class=14, batch_size=16))
    cfg = json.loads(path.read_text())
    cfg["model"] = {
        "transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 64,
                        "decoder_hidden": 64, "conv_filter_size": 256,
                        "conv_kernel_size": [9, 1], "encoder_dropout": 0.0,
                        "decoder_dropout": 0.0},
        "variance_predictor": {"dropout": 0.0, "filter_size": 64}, "postnet_channels": 64}
    path.write_text(json.dumps(cfg))
    jcfg, tcfg = jax_load_config(str(path)), load_config(str(path))
    jds = JaxDataset("train.txt", jcfg, sort=True, drop_last=True)
    jm = jvtts.VTTS.from_config(jcfg, JaxMetadata.load(jcfg.path.preprocessed),
                                n_vocab=jds.n_vocab)
    opt = dict(init_lr=1e-3, warmup_steps=40, grad_clip=1.0)
    tx = make_optimizer(**opt)
    first = next(jds.batches(shuffle=False))
    jstate = create_train_state(jm, tx, jax.random.PRNGKey(0), {
        k: jnp.asarray(v) for k, v in first.items() if k not in ("names", "mel_lens")})
    model = VTTS.from_config(tcfg, DatasetMetadata.load(tcfg.path.preprocessed),
                             n_vocab=jds.n_vocab)
    model.postnet.dropout.p = 0.0
    model.load_state_dict(vtts_state_dict(jax.tree.map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})))
    tstate = TrainState(model, NoamAdam(model.parameters(), **opt), torch.Generator())
    jstep = make_train_step(jm, tx)
    curve, epoch = [], 0
    while len(curve) < 400:
        epoch += 1
        for b in jds.batches(seed=epoch):
            jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()
                                        if k not in ("names", "mel_lens")},
                               jax.random.PRNGKey(0))
            tl = train_step(tstate, to_device(b, "cpu"))
            curve.append([float(jl["total_loss"]), float(tl["total_loss"]),
                          float(jl["mel_loss"]), float(tl["mel_loss"])])
            if len(curve) == 400:
                break
    means = np.asarray(curve).reshape(8, 50, 4).mean(axis=1)
    rel = {name: np.abs(means[:, col + 1] - means[:, col]) / means[:, col]
           for name, col in (("total_loss", 0), ("mel_loss", 2))}
    print("50-step means, relative gap to JAX's:", {k: v.tolist() for k, v in rel.items()})
    assert all(v.max() <= 0.01 for v in rel.values()), rel


def _dropout_runs(tmp_path, seeds, steps: int, own_draw: bool) -> dict:
    """Both packages side by side with dropout on (the config's rates, the
    PostNet's fixed 0.5), the 2-layer hidden-64 model on the synthetic corpus
    (2 x 14 clips, batch 16), `steps` steps per seed. A seed sets JAX's
    initial draw (PRNGKey(seed)), each package's dropout generator (seed + 1,
    as both trainers) and the batch order (seed + epoch, the same plans for
    both); the port starts from its own draw (torch.manual_seed(seed)) with
    `own_draw`, else from JAX's through the bridge. Returns {"jax", "port"}:
    arrays (seed, step, [total, mel, duration, energy]) of the losses."""
    import json
    import pathlib

    from test_torch_dataset import preprocessed_corpus

    from visual_onoma_to_wave_tpu.cli import load_config as jax_load_config
    from visual_onoma_to_wave_tpu.config import DatasetMetadata as JaxMetadata
    from visual_onoma_to_wave_tpu.data.dataset import OnomaDataset as JaxDataset
    from visual_onoma_to_wave_tpu_torch.config import DatasetMetadata
    from visual_onoma_to_wave_tpu_torch.data.dataset import to_device

    torch.set_num_threads(4)
    path = pathlib.Path(preprocessed_corpus(tmp_path, n_per_class=14, batch_size=16))
    cfg = json.loads(path.read_text())
    cfg["model"] = {
        "transformer": {"encoder_layer": 2, "decoder_layer": 2, "encoder_hidden": 64,
                        "decoder_hidden": 64, "conv_filter_size": 256,
                        "conv_kernel_size": [9, 1]},
        "variance_predictor": {"filter_size": 64}, "postnet_channels": 64}
    path.write_text(json.dumps(cfg))
    jcfg, tcfg = jax_load_config(str(path)), load_config(str(path))
    jds = JaxDataset("train.txt", jcfg, sort=True, drop_last=True)
    jmeta, tmeta = JaxMetadata.load(jcfg.path.preprocessed), DatasetMetadata.load(
        tcfg.path.preprocessed)
    opt = dict(init_lr=1e-3, warmup_steps=40, grad_clip=1.0)
    keys = ("total_loss", "mel_loss", "duration_loss", "energy_loss")
    curves = {"jax": [], "port": []}
    for seed in seeds:
        jm = jvtts.VTTS.from_config(jcfg, jmeta, n_vocab=jds.n_vocab)
        tx = make_optimizer(**opt)
        first = next(jds.batches(shuffle=False))
        jstate = create_train_state(jm, tx, jax.random.PRNGKey(seed), {
            k: jnp.asarray(v) for k, v in first.items() if k not in ("names", "mel_lens")})
        jstep, jrng = make_train_step(jm, tx), jax.random.PRNGKey(seed + 1)
        torch.manual_seed(seed)
        model = VTTS.from_config(tcfg, tmeta, n_vocab=jds.n_vocab)
        if not own_draw:
            model.load_state_dict(vtts_state_dict(jax.tree.map(
                np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})))
        tstate = TrainState(model, NoamAdam(model.parameters(), **opt),
                            torch.Generator().manual_seed(seed + 1))
        jc, tc, epoch = [], [], 0
        while len(jc) < steps:
            epoch += 1
            for b in jds.batches(seed=seed + epoch):
                jstate, jl = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()
                                            if k not in ("names", "mel_lens")}, jrng)
                tl = train_step(tstate, to_device(b, "cpu"))
                jc.append([float(jl[k]) for k in keys])
                tc.append([float(tl[k]) for k in keys])
                if len(jc) == steps:
                    break
        curves["jax"].append(jc)
        curves["port"].append(tc)
    return {k: np.asarray(v) for k, v in curves.items()}


@pytest.mark.slow  # ~10 min: 3 seeds x 400 steps of each package on the CPU
def test_side_by_side_spread_with_dropout(tmp_path):
    """The regime no other test compares: dropout on. The two packages draw
    their masks from different generators by construction, so no step can
    be held to a tolerance; their spread over seeds can. Three seeds, 400
    steps, each starting both packages from JAX's initial draw (as the test
    without dropout does; `_dropout_runs`): each 50-step mean of the port's
    total and mel losses must lie inside JAX's range over its seeds, widened
    by that range on each side. Each package's own draw is the next test's."""
    runs = _dropout_runs(tmp_path, range(3), 400, own_draw=False)
    jax_means, port_means = (runs[k][:, :, :2].reshape(3, 8, 50, 2).mean(axis=2)
                             for k in ("jax", "port"))                  # (seed, window, 2)
    lo, hi = jax_means.min(axis=0), jax_means.max(axis=0)
    spread = hi - lo
    print("50-step means (seed, window, [total, mel]); JAX:", jax_means.round(4).tolist(),
          "port:", port_means.round(4).tolist())
    print("port's distance outside JAX's seed range, in ranges:",
          (np.maximum(port_means - hi, lo - port_means).max(axis=0) / spread).round(3).tolist())
    assert np.all(port_means >= lo - spread) and np.all(port_means <= hi + spread)


@pytest.mark.slow  # ~7 min: 10 seeds x 50 steps of each package on the CPU
def test_first_steps_over_ten_seeds_with_own_draws(tmp_path):
    """Each package from its own initial draw, dropout on, ten seeds, 50
    steps (`_dropout_runs`): the first 50 steps' mean total loss is set by
    the draw (the duration loss above all), so three seeds do not bound it;
    over ten, the port's mean over seeds must lie within two standard errors
    of JAX's (the initialisers' distributions are held leaf by leaf in
    `test_initialisation_matches_flax`; this holds their effect on the
    first steps of training)."""
    runs = _dropout_runs(tmp_path, range(10), 50, own_draw=True)
    window = {k: v.mean(axis=1) for k, v in runs.items()}                 # (seed, 4)
    print("first 50 steps' mean [total, mel, duration, energy] per seed; JAX:",
          window["jax"].round(3).tolist(), "port:", window["port"].round(3).tolist())
    total = {k: v[:, 0] for k, v in window.items()}
    se = np.sqrt(sum(v.var(ddof=1) / len(v) for v in total.values()))
    gap = total["port"].mean() - total["jax"].mean()
    print(f"mean total: JAX {total['jax'].mean():.3f} +- {total['jax'].std(ddof=1):.3f}, "
          f"port {total['port'].mean():.3f} +- {total['port'].std(ddof=1):.3f}; "
          f"gap {gap:.3f} = {gap / se:.2f} standard errors")
    assert abs(gap) <= 2 * se
