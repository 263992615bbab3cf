"""B7, the acoustic model's conv kernel (`ops/conv1d.py`, `csrc/conv1d_tc.cu`).

On the CPU: the plain version (a channels-last implicit GEMM) against
`nn.Conv1d` at every conv shape of the ICASSP model and against the
modules' eval forward; each epilogue; the weight packing; the route and its
count; the export of the packed weight; and the kernel's arithmetic
repeated in plain PyTorch (`emulated`): each item's frames with zeros
outside them, each (16-channel chunk, tap) one fresh tensor-core sum of
3xTF32 products (hi and lo planes both rounded to TF32) added to an fp32
accumulator. That lands within chip_smoke's 1e-5 x
max |plain| fp32 bound at the ICASSP convs' depths; one TF32 product a
multiply-add (1xTF32) does not.

On the card (`gpu`): the kernel against the same conv in float64 at the
benchmark cells' shapes, 1xTF32 outside the bound, and the launch count.
(At the cells' depths cuDNN and the plain version, with TF32 off, sum in
fp32 to 8.6e-6 of max |out| at the PostNet's tanh outputs, B7 to 2.4e-6:
held to each other they would measure cuDNN. At K 400 and T 77 the three
read ~1-2e-6.)
"""
from __future__ import annotations

import copy

import pytest
import torch
from torch import nn

from visual_onoma_to_wave_tpu_torch import tracing
from visual_onoma_to_wave_tpu_torch.models import layers
from visual_onoma_to_wave_tpu_torch.models.layers import PositionwiseFeedForward, PostNet
from visual_onoma_to_wave_tpu_torch.models.vtts import VTTS
from visual_onoma_to_wave_tpu_torch.ops import conv1d
from visual_onoma_to_wave_tpu_torch.ops.convnext import tf32_round

# (cin, cout, k, act, bn) of every conv of the ICASSP model: a conv FFN's two
# (hidden 256, conv_filter_size 1024, kernel sizes 9 and 1) and the PostNet's
# five (80 mel bins, 512 channels, k 5)
ICASSP_CONVS = {
    "ffn_w1": (256, 1024, 9, "relu", False),
    "ffn_w2": (1024, 256, 1, "none", False),
    "postnet_0": (80, 512, 5, "tanh", True),
    "postnet_mid": (512, 512, 5, "tanh", True),
    "postnet_last": (512, 80, 5, "none", True),
}
# the encoder's text positions, a ragged T (not a multiple of 64), the
# decoder's max_mel_len
FRAMES = (8, 77, 1000)
BOUND = 1e-5      # chip_smoke's ATOL convention: 1e-5 x max |plain| in fp32


def conv_and_bn(cin: int, cout: int, k: int, seed: int):
    """A Conv1d of the ICASSP model's init and an eval BatchNorm whose
    running statistics and affine are not the identity."""
    torch.manual_seed(seed)
    conv = nn.Conv1d(cin, cout, k, padding="same")
    layers.init_like_flax(conv)
    nn.init.normal_(conv.bias, 0.0, 0.1)
    bn = layers.BatchNorm1d(cout, eps=1e-5).eval()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_(0.0, 0.1)
        bn.running_mean.normal_(0.0, 0.3)
        bn.running_var.uniform_(0.5, 2.0)
    return conv, bn


def module_path(x, conv, bn, act: str, use_bn: bool) -> torch.Tensor:
    """What the models compute through the modules, on (B, T, C)."""
    h = conv(x.transpose(1, 2))
    if use_bn:
        h = bn(h)
    h = {"relu": torch.relu, "tanh": torch.tanh, "none": lambda v: v}[act](h)
    return h.transpose(1, 2)


def stats(bn):
    return bn.weight, bn.bias, bn.running_mean, bn.running_var


def assert_within_bound(got: torch.Tensor, want: torch.Tensor, bound: float = BOUND) -> None:
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= bound * scale


@pytest.mark.parametrize("T", FRAMES)
@pytest.mark.parametrize("name", list(ICASSP_CONVS))
def test_plain_version_matches_the_modules(name, T):
    """`conv1d_tc_reference` (and the op on the CPU) against `nn.Conv1d`,
    its BatchNorm and activation at every ICASSP conv shape."""
    cin, cout, k, act, use_bn = ICASSP_CONVS[name]
    conv, bn = conv_and_bn(cin, cout, k, seed=cin + cout + k + T)
    x = torch.randn(2, T, cin, generator=torch.Generator().manual_seed(T))
    with torch.no_grad():
        want = module_path(x, conv, bn, act, use_bn)
        got = conv1d.conv1d_tc_reference(x, conv.weight, conv.bias, act,
                                         stats(bn) if use_bn else None, bn.eps)
        op = conv1d.conv1d_tc(x, conv.weight, conv.bias, act, stats(bn) if use_bn else None,
                              bn.eps)
    assert got.shape == (2, T, cout)
    assert_within_bound(got, want)
    assert torch.equal(op, got)


@pytest.mark.parametrize("act,use_bn", [("relu", False), ("none", False), ("tanh", True),
                                        ("none", True), ("relu", True), ("tanh", False)],
                         ids=["bias+relu", "bias", "bn+tanh", "bn", "bn+relu", "tanh"])
def test_each_epilogue(act, use_bn):
    """Bias + ReLU (a conv FFN's first conv), bias (its second), the eval
    BatchNorm with and without tanh (the PostNet's convs), and the other
    combinations the op takes, against the modules; the BatchNorm's
    arithmetic is the one `csrc/conv1d_tc.cu` applies."""
    conv, bn = conv_and_bn(32, 128, 3, seed=7)
    x = torch.randn(3, 50, 32, generator=torch.Generator().manual_seed(8)) * 2.0
    with torch.no_grad():
        want = module_path(x, conv, bn, act, use_bn)
        got = conv1d.conv1d_tc(x, conv.weight, conv.bias, act, stats(bn) if use_bn else None,
                               bn.eps)
        v = conv(x.transpose(1, 2)).transpose(1, 2)
    assert_within_bound(got, want)
    if use_bn:     # the BatchNorm moved the values: the epilogue applied it
        assert float((want - module_path(x, conv, bn, act, False)).abs().max()) > 0.1
    if act == "relu":
        assert float(got.min()) == 0.0 and float(v.min()) < 0.0


def test_the_modules_eval_forward_through_the_op(monkeypatch):
    """The conv FFN and the PostNet with their B7 route forced on the CPU
    (the op's plain version) against their module route in `.eval()`."""
    torch.manual_seed(3)
    ffn = PositionwiseFeedForward(256, 1024, (9, 1)).eval()
    post = PostNet(80, 512).eval()
    for _, bn in post.convolutions:
        with torch.no_grad():
            bn.running_mean.normal_(0.0, 0.2)
            bn.running_var.uniform_(0.5, 2.0)
    x = torch.randn(2, 77, 256)
    mel = torch.randn(2, 77, 80)
    with torch.no_grad():
        want = ffn(x), post(mel)
        assert not ffn.kernel_convs(x.device) and not post.kernel_convs(x.device)
        monkeypatch.setattr(layers, "runs_kernel", lambda device, dtype, training: True)
        assert ffn.kernel_convs(x.device) == [ffn.w_1, ffn.w_2]
        assert post.kernel_convs(x.device) == [c.conv for c, _ in post.convolutions]
        got = ffn(x), post(mel)
    for g, w in zip(got, want):
        assert_within_bound(g, w)


def test_packing_holds_every_weight_once():
    """`pack_conv1d_weight`'s stream, undone, is the weight: hi rounded to
    TF32 and lo the TF32 rounding of the rest (hi + lo within 2^-21 of the
    fp32 weight), in the (tile, chunk, tap) order and core-matrix layout
    that the kernel reads."""
    for cin, cout, k in ((32, 256, 3), (48, 80, 5)):
        w = torch.randn(cout, cin, k, generator=torch.Generator().manual_seed(cout))
        packed = conv1d.pack_conv1d_weight(w)
        nt = conv1d.tile_n(cout)
        planes = packed.reshape(cout // nt, cin // 16, k, 2, 4, nt // 8, 8, 4)
        # [tile, chunk, tap, split, K group, N core, row, 4] -> [split, co, ci, tap]
        u = planes.permute(3, 0, 5, 6, 1, 4, 7, 2).reshape(2, cout, cin, k)
        assert torch.equal(u[0], tf32_round(w))
        assert torch.equal(u[1], tf32_round(w - u[0]))
        assert float(((u[0] + u[1] - w).abs() / w.abs()).max()) <= 2.0 ** -21
        assert packed.numel() == 2 * w.numel()


def test_the_kernel_weight_is_packed_again_only_when_it_changes():
    conv, _ = conv_and_bn(16, 128, 3, seed=1)
    first = conv1d.kernel_weight(conv)
    assert conv1d.kernel_weight(conv) is first
    assert "kernel_weight" not in conv.state_dict()
    with torch.no_grad():
        conv.weight.mul_(2.0)
    again = conv1d.kernel_weight(conv)
    assert again is not first and torch.equal(again, conv1d.pack_conv1d_weight(conv.weight))


@pytest.mark.parametrize("cin,cout,k", [(24, 128, 3), (32, 96, 3), (32, 128, 4), (32, 128, 33)])
def test_shapes_the_kernel_does_not_take(cin, cout, k):
    assert not conv1d.conv1d_tc_takes(cin, cout, k)
    with pytest.raises(ValueError):
        conv1d.pack_conv1d_weight(torch.zeros(cout, cin, k))


def emulated(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, three: bool = True):
    """The kernel's arithmetic before its epilogue, in plain PyTorch (see
    the module docstring): each item's frames with zeros outside them, each
    chunk's taps cut as the kernel cuts them (as few groups of at most 5 as
    they need, near equal), each group a fresh sum of the window's hi / lo
    against the packed hi / lo (exact products summed in float64 and
    rounded once), added to the fp32 accumulator in (chunk, group) order;
    then + bias. Each output row's sums are its own, whatever tile or row
    space holds it."""
    B, T, cin = x.shape
    cout, _, k = weight.shape
    pad = (k - 1) // 2
    rows = torch.nn.functional.pad(x, (0, 0, pad, pad))
    hi = tf32_round(rows)
    lo = tf32_round(rows - hi)
    w_hi = tf32_round(weight)
    w_lo = tf32_round(weight - w_hi)
    taps = -(-k // -(-k // 5))
    acc = torch.zeros(B, T, cout)
    for c in range(0, cin, 16):
        for j0 in range(0, k, taps):
            fresh = torch.zeros(B, T, cout, dtype=torch.float64)
            for j in range(j0, min(j0 + taps, k)):
                a_hi = hi[:, j:j + T, c:c + 16].double()
                a_lo = lo[:, j:j + T, c:c + 16].double()
                b_hi = w_hi[:, c:c + 16, j].double().t()
                b_lo = w_lo[:, c:c + 16, j].double().t()
                fresh += a_hi @ b_hi
                if three:
                    fresh += a_hi @ b_lo + a_lo @ b_hi
            acc = acc + fresh.float()
    return acc + bias


@pytest.mark.parametrize("name,T", [("ffn_w1", 77), ("ffn_w1", 8), ("ffn_w2", 77),
                                    ("postnet_mid", 77), ("postnet_0", 40)])
def test_emulated_kernel_arithmetic_is_fp32_and_one_tf32_product_is_not(name, T):
    """3xTF32 in the kernel's order over the row space lands within 1e-5 x
    max |plain| of the fp32 plain version; one TF32 product a multiply-add
    misses that bound at the depths of the ICASSP convs (K 80 x 5 to 1024)."""
    cin, cout, k, _, _ = ICASSP_CONVS[name]
    conv, _ = conv_and_bn(cin, cout, k, seed=k + T)
    x = torch.randn(3, T, cin, generator=torch.Generator().manual_seed(cin))
    with torch.no_grad():
        want = conv1d.conv1d_tc_reference(x, conv.weight, conv.bias)
        three = emulated(x, conv.weight, conv.bias)
        one = emulated(x, conv.weight, conv.bias, three=False)
    scale = float(want.abs().max())
    assert float((three - want).abs().max()) <= BOUND * scale
    assert float((one - want).abs().max()) > BOUND * scale


def test_route_and_plan_of_the_icassp_model():
    """25 convs a forward (10 conv FFNs x 2 + the PostNet's 5): all on B7
    on the card in `.eval()` at fp32; all as modules in `.train()`, at bf16
    compute or on the CPU. The route looks at no width: a PostNet of widths
    the kernel does not take is sent to B7 too (where it raises, below), and
    does not fall back to the modules."""
    from visual_onoma_to_wave_tpu_torch.config import load_config

    cfg = load_config("configs/icassp.yaml")
    model = VTTS.from_config(cfg, max_mel_len=40).eval()
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert model.acoustic_conv_plan(cuda) == (25, 0)
    assert model.acoustic_conv_plan(cpu) == (0, 25)
    assert model.train().acoustic_conv_plan(cuda) == (0, 25)
    bf16 = VTTS(n_vocab=10, n_audiotype=3, use_image=False, dtype=torch.bfloat16).eval()
    assert bf16.acoustic_conv_plan(cuda) == (0, 25)
    odd = VTTS(n_vocab=10, n_audiotype=3, use_image=False, encoder_layers=1, decoder_layers=1,
               postnet_dim=100).eval()
    assert odd.acoustic_conv_plan(cuda) == (9, 0)


# a conv the route may send to B7 that the kernel does not compute: widths
# (100 PostNet channels: cout not a multiple of 128 nor 80; cin 100 not a
# multiple of 16), an even k, no bias, no SAME padding, a stride
ODD_CONVS = {
    "cout100": lambda: nn.Conv1d(512, 100, 5, padding="same"),
    "cin100": lambda: nn.Conv1d(100, 512, 5, padding="same"),
    "k4": lambda: nn.Conv1d(256, 256, 4, padding="same"),
    "no_bias": lambda: nn.Conv1d(256, 256, 5, padding="same", bias=False),
    "pad0": lambda: nn.Conv1d(256, 256, 5, padding=0),
    "stride2": lambda: nn.Conv1d(256, 256, 1, stride=2),
}


@pytest.mark.parametrize("name", list(ODD_CONVS))
def test_a_conv_the_kernel_does_not_compute_raises_on_its_route(name):
    """`conv1d_module`, what the models call on B7's route, refuses such a
    conv with a ValueError before packing or launching anything."""
    conv = ODD_CONVS[name]()
    x = torch.randn(2, 16, conv.in_channels)
    assert not conv1d.module_takes(conv)
    with torch.no_grad(), pytest.raises(ValueError, match="does not compute"):
        conv1d.conv1d_module(x, conv)
    assert "kernel_weight" not in conv._buffers




def test_fused_call_counts_the_acoustic_convs_once_a_call():
    """`make_fused_infer` counts `synth.acoustic_convs` /
    `synth.acoustic_convs_plain` once a call from the model's plan inside
    `synth.acoustic`: on the CPU the ICASSP model's 25 convs as modules."""
    from visual_onoma_to_wave_tpu_torch.config import load_config
    from visual_onoma_to_wave_tpu_torch.models import get_vocoder
    from visual_onoma_to_wave_tpu_torch.synthesis import make_fused_infer

    cfg = load_config("configs/icassp.yaml")
    torch.manual_seed(0)
    model = VTTS.from_config(cfg, max_mel_len=24).eval()
    gen = get_vocoder("HiFi-GAN", upsample_initial_channel=32).eval()
    B, C = 2, 3
    batch = {"audiotypes": torch.zeros(B, dtype=torch.long),
             "texts": torch.ones(B, C, dtype=torch.long),
             "src_lens": torch.full((B,), C),
             "image_cells": torch.rand(B, C, 24, 102)}
    fused = make_fused_infer(model, gen)
    for _ in range(2):
        before = tracing.counters()
        fused(batch)
        after = tracing.counters()
        got = tuple(after.get(k, 0) - before.get(k, 0)
                    for k in ("synth.acoustic_convs", "synth.acoustic_convs_plain"))
        assert got == (0, 25)


class _ConvStep(nn.Module):
    """A conv FFN's first conv and a PostNet-style conv through the op."""

    def __init__(self):
        super().__init__()
        self.a, _ = conv_and_bn(16, 128, 3, seed=11)
        self.b, self.bn = conv_and_bn(128, 80, 5, seed=12)

    def forward(self, x):
        return conv1d.conv1d_module(conv1d.conv1d_module(x, self.a, "relu"), self.b, "none",
                                    self.bn)


def test_export_records_the_op_and_holds_the_packed_weight():
    """Under `torch.export` the convs' packed weights are taken as they
    stand (buffers, packed before the trace), the graph calls
    `votw::conv1d_tc` by name, and the program computes what eager does."""
    step = _ConvStep().eval()
    x = torch.randn(2, 20, 16)
    with torch.no_grad():
        want = step(x)           # packs both weights
        program = torch.export.export(step, (x,))
        got = program.module()(x)
    assert any("conv1d_tc" in str(n.target) for n in program.graph.nodes)
    assert {"a.kernel_weight", "b.kernel_weight"} <= set(program.constants) | set(
        program.state_dict) | {s.target for s in program.graph_signature.input_specs
                               if s.target}
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    fresh = _ConvStep().eval()
    with pytest.raises(RuntimeError, match="not packed"):
        torch.export.export(fresh, (x,))


# ----------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from visual_onoma_to_wave_tpu_torch.precision import pin_fp32

    pin_fp32()   # the plain version's matmul and cuDNN in IEEE fp32, not TF32
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(64, 1000), (64, 8), (3, 77)], ids=["cell", "encoder", "ragged"])
@pytest.mark.parametrize("name", list(ICASSP_CONVS))
def test_kernel_matches_plain_and_cudnn(cuda, name, B, T):
    """B7 at the benchmark cells' shapes (B 64 x T 1000; the encoder's T 8)
    and a ragged one, against the conv in float64: within 1e-5 x max (the
    distances of cuDNN with TF32 off and of the plain version in the
    message); the same launch with the lo products made zero (1xTF32: the
    input rounded to TF32, the weights' lo plane 0) is not within the
    bound; one launch a call."""
    cin, cout, k, act, use_bn = ICASSP_CONVS[name]
    conv, bn = conv_and_bn(cin, cout, k, seed=B + T + cin)
    conv, bn = conv.to(cuda), bn.to(cuda)
    x = torch.randn(B, T, cin, generator=torch.Generator().manual_seed(T)).to(cuda)
    s = stats(bn) if use_bn else None
    with torch.inference_mode():
        packed = conv1d.pack_conv1d_weight(conv.weight)
        before = conv1d.conv1d_tc.launches
        got = conv1d.conv1d_tc(x, conv.weight, conv.bias, act, s, bn.eps, packed)
        torch.cuda.synchronize()
        assert conv1d.conv1d_tc.launches == before + 1
        want = module_path(x, conv, bn, act, use_bn)
        plain = conv1d.conv1d_tc_reference(x, conv.weight, conv.bias, act, s, bn.eps)
        one = packed.clone().reshape(-1, 2, conv1d.tile_n(cout) * 16)
        one[:, 1] = 0.0
        single = conv1d.conv1d_tc(tf32_round(x), conv.weight, conv.bias, act, s, bn.eps,
                                  one.reshape(-1))
        exact = module_path(x.double(), copy.deepcopy(conv).double(),
                            copy.deepcopy(bn).double(), act, use_bn)
    scale = float(exact.abs().max())
    err = {k: float((t.double() - exact).abs().max()) / scale
           for k, t in (("b7", got), ("cudnn", want), ("plain", plain), ("1xtf32", single))}
    assert err["b7"] <= BOUND, err
    assert err["1xtf32"] > BOUND, err


@pytest.mark.gpu
def test_icassp_model_takes_b7_on_the_card(cuda):
    """The ICASSP model in `.eval()` on the card: 25 launches a forward, the
    output within the fp32 bound of the same model through cuDNN (the
    modules in `.eval()` with the route turned off)."""
    from visual_onoma_to_wave_tpu_torch.config import load_config

    cfg = load_config("configs/icassp.yaml")
    torch.manual_seed(0)
    model = VTTS.from_config(cfg, max_mel_len=300).to(cuda).eval()
    B, C = 4, 6
    g = torch.Generator().manual_seed(1)
    batch = dict(audiotypes=torch.zeros(B, dtype=torch.long, device=cuda),
                 texts=torch.ones(B, C, dtype=torch.long, device=cuda),
                 src_lens=torch.tensor([6, 5, 4, 6], device=cuda),
                 image_cells=torch.rand(B, C, 24, 102, generator=g).to(cuda))
    with torch.inference_mode():
        before = conv1d.conv1d_tc.launches
        got = model(**batch, d_control=8.0)["postnet_mel"]
        torch.cuda.synchronize()
        assert conv1d.conv1d_tc.launches == before + 25
    original = layers.runs_kernel
    layers.runs_kernel = lambda device, dtype, training: False
    try:
        with torch.inference_mode():
            want = model(**batch, d_control=8.0)["postnet_mel"]
    finally:
        layers.runs_kernel = original
    assert_within_bound(got, want)


@pytest.mark.gpu
def test_widths_the_kernel_does_not_take_raise_on_the_card(cuda):
    """A model whose PostNet has 100 channels, in `.eval()` at fp32 on the
    card, is routed to B7 and raises there; nothing runs it on cuDNN
    instead."""
    odd = VTTS(n_vocab=10, n_audiotype=3, use_image=False, encoder_layers=1, decoder_layers=1,
               postnet_dim=100, max_mel_len=40).to(cuda).eval()
    B, C = 2, 4
    batch = dict(audiotypes=torch.zeros(B, dtype=torch.long, device=cuda),
                 texts=torch.ones(B, C, dtype=torch.long, device=cuda),
                 src_lens=torch.full((B,), C, device=cuda))
    with torch.inference_mode(), pytest.raises(ValueError, match="does not compute"):
        odd(**batch)


@pytest.mark.gpu
def test_the_kernel_needs_the_packed_weight(cuda):
    """On the card the op is given the weight packed once; a call without it
    raises instead of packing per call, and launches nothing."""
    conv, _ = conv_and_bn(16, 128, 3, seed=2)
    conv = conv.to(cuda)
    x = torch.randn(1, 8, 16, device=cuda)
    before = conv1d.conv1d_tc.launches
    with torch.inference_mode(), pytest.raises(ValueError, match="packed"):
        conv1d.conv1d_tc(x, conv.weight, conv.bias)
    assert conv1d.conv1d_tc.launches == before
