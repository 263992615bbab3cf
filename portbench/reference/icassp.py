"""Plain reference of the ICASSP visual-onomatopoeia acoustic model and of the
serving renderer, in PyTorch operations and float32, with no kernel, cache
or batching of the program's.

The model (arXiv:2210.09173; sarulab-speech/visual-onoma-to-wave, config
ICASSP): per-character glyph cells -> visual feature extractor (3 x [conv
3x3 -> BatchNorm -> ReLU], Linear -> ReLU) -> sinusoid positions -> encoder
FFT blocks (post-LN multi-head attention with a key mask, conv FFN 9 / 1)
-> + sound-class embedding -> variance adaptor (duration and energy
predictors; energy bucketised and embedded; durations round(exp(log d) - 1)
x d_control, clamped at 0 and truncated) -> length regulator to
`max_mel_len` frames -> decoder FFT blocks -> mel_linear -> 5-conv PostNet
added to the mel. Every BatchNorm in inference form.

Padding follows the serving path's documented shapes, since the answer
depends on them: a request is computed at the padded text length of the
batch it was served in (the variance predictors' convolutions read the
positions past the text, which hold the sound-class embedding), and at
`max_mel_len` frames (the PostNet reads the frames past the clip).

`q` rounds the operands of every product (linear, convolution, attention
product); the identity gives the float32 reference, and a rounding to a
lower precision gives the control.

The renderer is a frozen copy of the serving renderer's arithmetic: a
glyph of the configured font, or of PIL's default font when that cannot be
loaded, or a stroke pattern seeded by the code point when the font has no
glyph, resized to round(fontsize x rate) pixels and centred in its cell.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image, ImageDraw, ImageFont

from pbcore.costs import conv_flops


def ident(t: torch.Tensor) -> torch.Tensor:
    return t


# ---------------------------------------------------------------- weights
def param_specs(ac: dict, init: dict, n_audiotype: int) -> list[tuple]:
    """(name, shape, kind, value) of every parameter and buffer, named as the
    serving model's state dict names them. kind: "normal" (std), "uniform"
    (half width), "const" (fill value)."""
    d, inner, k1, k2 = ac["hidden"], ac["d_inner"], *ac["ffn_kernel"]
    f, vk, p, m = ac["vp_filter"], ac["vp_kernel"], ac["postnet_dim"], ac["n_mels"]
    h, w = ac["cell_hw"]
    lecun = lambda fan_in: 1.0 / math.sqrt(fan_in)   # noqa: E731
    specs = []

    def linear(name, c_in, c_out, std=None, bias=0.0):
        specs.append((f"{name}.weight", (c_out, c_in), "normal", std or lecun(c_in)))
        specs.append((f"{name}.bias", (c_out,), "const", bias))

    def conv(name, c_in, c_out, k):
        specs.append((f"{name}.weight", (c_out, c_in, k), "normal", lecun(c_in * k)))
        specs.append((f"{name}.bias", (c_out,), "const", 0.0))

    def norm(name, c, running=False):
        specs.append((f"{name}.weight", (c,), "const", 1.0))
        specs.append((f"{name}.bias", (c,), "const", 0.0))
        if running:
            specs.append((f"{name}.running_mean", (c,), "const", 0.0))
            specs.append((f"{name}.running_var", (c,), "const", 1.0))
            specs.append((f"{name}.num_batches_tracked", (), "const", 0))

    def stack(prefix, layers):
        for i in range(layers):
            b = f"{prefix}.layer_stack.{i}"
            for proj in ("w_qs", "w_ks", "w_vs", "fc"):
                linear(f"{b}.slf_attn.{proj}", d, d)
            norm(f"{b}.slf_attn.layer_norm", d)
            conv(f"{b}.pos_ffn.w_1", d, inner, k1)
            conv(f"{b}.pos_ffn.w_2", inner, d, k2)
            norm(f"{b}.pos_ffn.layer_norm", d)

    stack("encoder", ac["encoder_layers"])
    vfe = "encoder.VisualFeatureExtractor"
    u = init["vfe_uniform"]
    for i in range(ac["vfe_layers"]):
        c = f"{vfe}.embedder.{3 * i}"
        specs += [(f"{c}.weight", (1, 1, *ac["vfe_kernel"]), "uniform", u),
                  (f"{c}.bias", (1,), "uniform", u)]
        bn = f"{vfe}.embedder.{3 * i + 1}"
        specs += [(f"{bn}.weight", (1,), "uniform", u), (f"{bn}.bias", (1,), "uniform", u),
                  (f"{bn}.running_mean", (1,), "const", 0.0),
                  (f"{bn}.running_var", (1,), "const", 1.0),
                  (f"{bn}.num_batches_tracked", (), "const", 0)]
    specs += [(f"{vfe}.bridge.0.weight", (d, h * w), "uniform", u),
              (f"{vfe}.bridge.0.bias", (d,), "uniform", u)]
    specs.append(("audiotype_emb.weight", (n_audiotype, d), "normal", lecun(d)))
    for pred in ("duration_predictor", "energy_predictor"):
        b = f"variance_adaptor.{pred}"
        conv(f"{b}.conv_layer.conv1d_1.conv", d, f, vk)
        norm(f"{b}.conv_layer.layer_norm_1", f)
        conv(f"{b}.conv_layer.conv1d_2.conv", f, f, vk)
        norm(f"{b}.conv_layer.layer_norm_2", f)
        if pred == "duration_predictor":
            # ~frames_per_char frames a character at d_control 1: the bias
            # log(frames + 1), the weight scaled down
            linear(f"{b}.linear_layer", f, 1, std=lecun(f) * init["duration_weight_scale"],
                   bias=math.log(init["frames_per_char"] + 1))
        else:
            linear(f"{b}.linear_layer", f, 1)
    specs.append(("variance_adaptor.energy_embedding.weight", (ac["n_bins"], d), "normal",
                  lecun(d)))
    stack("decoder", ac["decoder_layers"])
    linear("mel_linear", d, m)
    dims = [m, p, p, p, p, m]
    for i in range(5):
        conv(f"postnet.convolutions.{i}.0.conv", dims[i], dims[i + 1], 5)
        norm(f"postnet.convolutions.{i}.1", dims[i + 1], running=True)
    return specs


# --------------------------------------------------------------- renderer
@lru_cache(maxsize=8)
def _font(path: str, size: int):
    try:
        return ImageFont.truetype(path, size)
    except Exception:
        try:
            return ImageFont.load_default(size=size)
        except TypeError:
            return ImageFont.load_default()


@lru_cache(maxsize=64)
def _cmap(path: str):
    try:
        from fontTools.ttLib import TTFont

        tt = TTFont(path, fontNumber=0, lazy=True)
        try:
            return frozenset(tt.getBestCmap())
        finally:
            tt.close()
    except Exception:
        return None


def _mask(font, ch: str, size: int) -> np.ndarray:
    im = Image.new("L", (size, size), 0)
    ImageDraw.Draw(im).text((0, 0), ch, fill=255, font=font)
    return np.asarray(im)


@lru_cache(maxsize=4096)
def _has_glyph(path: str, size: int, ch: str) -> bool:
    cmap = _cmap(path)
    if cmap is not None:
        return ord(ch) in cmap
    font = _font(path, size)
    return not np.array_equal(_mask(font, ch, size), _mask(font, "\ue000", size))


def _cell(ch: str, path: str, size: int, bg, fg) -> Image.Image:
    cell = Image.new("RGB", (size, size), bg)
    d = ImageDraw.Draw(cell)
    if _has_glyph(path, size, ch):
        d.text((0, 0), ch, fill=fg, font=_font(path, size))
        return cell
    rng = np.random.default_rng(ord(ch))
    pad, lw = max(2, size // 8), max(1, size // 10)
    pts = rng.integers(pad, max(pad + 1, size - pad), (4, 2))
    for i in range(3):
        d.line([tuple(pts[i]), tuple(pts[i + 1])], fill=fg, width=lw)
    cx, cy = rng.integers(pad, max(pad + 1, size - pad), 2)
    r = int(rng.integers(2, max(3, size // 4)))
    d.ellipse([cx - r, cy - r, cx + r, cy + r], outline=fg, width=max(1, size // 12))
    return cell


def render(text: str, width_rates, ac: dict) -> np.ndarray:
    """(fontsize, len(text) * cell width) uint8 grey strip."""
    size, cw = ac["fontsize"], ac["cell_hw"][1]
    bg, fg = (255, 255, 255), (0, 0, 0)
    canvas = Image.new("RGB", (cw * len(text), size), bg)
    for i, (ch, rate) in enumerate(zip(text, width_rates)):
        g = max(1, int(round(size * rate)))
        cell = _cell(ch, ac["font"], size, bg, fg).resize((g, size))
        canvas.paste(cell, (i * cw + (cw - g) // 2 + (cw - g) % 2, 0))
    return np.asarray(canvas.convert("L"), dtype=np.uint8)


def cells_of(strip: np.ndarray, n: int, cw: int) -> np.ndarray:
    """(n, H, cw) float32 cells in [0, 1] of a rendered strip."""
    h = strip.shape[0]
    return strip.reshape(h, n, cw).transpose(1, 0, 2).astype(np.float32) / 255.0


# ------------------------------------------------------------------ model
def sinusoid(n: int, d: int) -> torch.Tensor:
    pos = np.arange(n, dtype=np.float64)[:, None]
    dim = np.arange(d, dtype=np.float64)[None, :]
    angle = pos / np.power(10000.0, 2.0 * (dim // 2) / d)
    table = np.where(np.arange(d)[None, :] % 2 == 0, np.sin(angle), np.cos(angle))
    return torch.from_numpy(table.astype(np.float32))


class Acoustic:
    """The model over a dict of float32 tensors `p` (names of `param_specs`)."""

    def __init__(self, p: dict, ac: dict, metadata: dict, q=ident):
        self.p, self.ac, self.q = p, ac, q
        self.energy_stats = metadata["energy_stats"]
        lo, hi = self.energy_stats[0], self.energy_stats[1]
        dev = p["mel_linear.weight"].device
        self.bins = torch.from_numpy(np.linspace(lo, hi, ac["n_bins"] - 1).astype(np.float32)).to(dev)
        self.table = sinusoid(max(ac["max_seq_len"], ac["max_mel_len"]) + 1, ac["hidden"]).to(dev)

    # layers
    def linear(self, x, name):
        return F.linear(self.q(x), self.q(self.p[f"{name}.weight"]), self.p[f"{name}.bias"])

    def conv(self, x, name):
        """(B, T, C) -> (B, T, C') SAME conv."""
        w = self.p[f"{name}.weight"]
        y = F.conv1d(self.q(x.transpose(1, 2)), self.q(w), self.p[f"{name}.bias"],
                     padding=w.shape[-1] // 2)
        return y.transpose(1, 2)

    def ln(self, x, name, eps=1e-5):
        return F.layer_norm(x, x.shape[-1:], self.p[f"{name}.weight"], self.p[f"{name}.bias"], eps)

    def bn(self, x, name, eps=1e-5):
        """Inference BatchNorm over axis 1."""
        p, shape = self.p, (1, -1) + (1,) * (x.ndim - 2)
        scale = p[f"{name}.weight"] / torch.sqrt(p[f"{name}.running_var"] + eps)
        return (x - p[f"{name}.running_mean"].reshape(shape)) * scale.reshape(shape) \
            + p[f"{name}.bias"].reshape(shape)

    def attention(self, x, pad, name):
        b, t, d = x.shape
        heads = self.ac["heads"]
        dk = d // heads
        qh, kh, vh = (self.linear(x, f"{name}.{w}").reshape(b, t, heads, dk)
                      for w in ("w_qs", "w_ks", "w_vs"))
        logits = torch.einsum("bqhd,bkhd->bhqk", self.q(qh), self.q(kh)) / math.sqrt(dk)
        logits = logits.masked_fill(pad[:, None, None, :], -math.inf)
        attn = torch.nan_to_num(torch.softmax(logits, dim=-1))
        ctx = torch.einsum("bhqk,bkhd->bqhd", self.q(attn), self.q(vh)).reshape(b, t, d)
        return self.ln(self.linear(ctx, f"{name}.fc") + x, f"{name}.layer_norm")

    def stack(self, x, pad, prefix, layers):
        for i in range(layers):
            b = f"{prefix}.layer_stack.{i}"
            x = self.attention(x, pad, f"{b}.slf_attn").masked_fill(pad[..., None], 0.0)
            h = self.conv(torch.relu(self.conv(x, f"{b}.pos_ffn.w_1")), f"{b}.pos_ffn.w_2")
            x = self.ln(h + x, f"{b}.pos_ffn.layer_norm").masked_fill(pad[..., None], 0.0)
        return x

    def predictor(self, x, pad, name):
        c = f"{name}.conv_layer"
        h = self.ln(torch.relu(self.conv(x, f"{c}.conv1d_1.conv")), f"{c}.layer_norm_1")
        h = self.ln(torch.relu(self.conv(h, f"{c}.conv1d_2.conv")), f"{c}.layer_norm_2")
        return self.linear(h, f"{name}.linear_layer")[..., 0].masked_fill(pad, 0.0)

    def vfe(self, cells):
        b, c, h, w = cells.shape
        x = cells.reshape(b * c, 1, h, w)
        pre = "encoder.VisualFeatureExtractor"
        for i in range(self.ac["vfe_layers"]):
            wt = self.p[f"{pre}.embedder.{3 * i}.weight"]
            x = F.conv2d(self.q(x), self.q(wt), self.p[f"{pre}.embedder.{3 * i}.bias"],
                         padding=(wt.shape[-2] // 2, wt.shape[-1] // 2))
            x = torch.relu(self.bn(x, f"{pre}.embedder.{3 * i + 1}"))
        return torch.relu(self.linear(x.reshape(b * c, -1), f"{pre}.bridge.0")).reshape(b, c, -1)

    # the two halves
    def encode(self, cells, audiotypes, src_lens, e_control, d_control) -> dict:
        """cells (B, C, H, W) at the served padded length C; per-row controls.
        Returns the encoder state, log durations, durations and energies."""
        b, c = cells.shape[:2]
        ac = self.ac
        pad = torch.arange(c, device=cells.device)[None, :] >= src_lens[:, None]
        x = self.stack(self.vfe(cells) + self.table[:c][None], pad, "encoder",
                       ac["encoder_layers"])
        x = x + self.p["audiotype_emb.weight"][audiotypes][:, None, :]
        log_d = self.predictor(x, pad, "variance_adaptor.duration_predictor")
        e = self.predictor(x, pad, "variance_adaptor.energy_predictor")
        lo, hi, mean, std = self.energy_stats
        e = ((e * std + mean) * e_control[:, None] - mean) / std
        raw = torch.exp(log_d) - 1.0
        dur = torch.clamp(torch.round(raw) * d_control[:, None], min=0.0).masked_fill(pad, 0.0)
        return {"x": x, "pad": pad, "log_d": log_d, "raw": raw, "energy": e,
                "durations": dur.to(torch.int32), "bucket": torch.bucketize(e, self.bins)}

    def decode(self, x, bucket, durations) -> dict:
        """The variance adaptor's rest, the decoder and the PostNet, with the
        given energy buckets and (B, C) integer durations."""
        ac = self.ac
        x = x + self.p["variance_adaptor.energy_embedding.weight"][bucket]
        t = ac["max_mel_len"]
        bounds = torch.cumsum(durations.long(), -1)
        frame = torch.arange(t, device=x.device)
        char = torch.searchsorted(bounds, frame.expand(x.shape[0], t).contiguous(), right=True)
        valid = frame[None, :] < bounds[:, -1:]
        x = torch.gather(x, 1, torch.where(valid, char, 0)[..., None].expand(-1, -1, x.shape[-1]))
        x = x.masked_fill(~valid[..., None], 0.0)
        mel_lens = torch.clamp(bounds[:, -1], max=t)
        pad = frame[None, :] >= mel_lens[:, None]
        x = self.stack(x + self.table[:t][None], pad, "decoder", ac["decoder_layers"])
        mel = self.linear(x, "mel_linear")
        h = mel.transpose(1, 2)
        for i in range(5):
            w = self.p[f"postnet.convolutions.{i}.0.conv.weight"]
            h = F.conv1d(self.q(h), self.q(w), self.p[f"postnet.convolutions.{i}.0.conv.bias"],
                         padding=w.shape[-1] // 2)
            h = self.bn(h, f"postnet.convolutions.{i}.1")
            if i < 4:
                h = torch.tanh(h)
        return {"mel_lens": mel_lens, "postnet_mel": mel + h.transpose(1, 2)}


# ------------------------------------------------------------------ FLOPs
def fft_block_flops(tokens: int, hidden: int, inner: int, kernels) -> float:
    """One FFT block over its own `tokens`: four projections, both attention
    products over the tokens, the conv FFN."""
    t = float(tokens)
    return (4 * 2.0 * t * hidden * hidden + 4.0 * t * t * hidden
            + conv_flops(t, hidden, inner, kernels[0]) + conv_flops(t, inner, hidden, kernels[1]))


def flops(acoustic: dict, chars: int, frames: int) -> float:
    """The model's FLOPs for one request of `chars` characters and `frames`
    mel frames, its own lengths only: the visual feature extractor per cell,
    the encoder FFT blocks over the characters, the duration and energy
    predictors, the decoder FFT blocks over the frames, mel_linear and the
    PostNet."""
    d, inner, k = acoustic["hidden"], acoustic["d_inner"], acoustic["ffn_kernel"]
    h, w = acoustic["cell_hw"]
    vfe = chars * (acoustic["vfe_layers"] * 2.0 * 9 * h * w + 2.0 * h * w * d)
    enc = acoustic["encoder_layers"] * fft_block_flops(chars, d, inner, k)
    f, vk = acoustic["vp_filter"], acoustic["vp_kernel"]
    predictors = 2 * (conv_flops(chars, d, f, vk) + conv_flops(chars, f, f, vk) + 2.0 * chars * f)
    dec = acoustic["decoder_layers"] * fft_block_flops(frames, d, inner, k)
    n_mels, p = acoustic["n_mels"], acoustic["postnet_dim"]
    post = sum(conv_flops(frames, a, b, 5) for a, b in
               ((n_mels, p), (p, p), (p, p), (p, p), (p, n_mels)))
    return vfe + enc + predictors + dec + 2.0 * frames * d * n_mels + post
