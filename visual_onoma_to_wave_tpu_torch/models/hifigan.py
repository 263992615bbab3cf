"""HiFi-GAN generator, inference (port of visual_onoma_to_wave_tpu/models/hifigan.py).

Mel (B, T, n_mels) feature-last -> waveform (B, T * prod(upsample_rates)).
Conv1d / ConvTranspose1d(stride u, padding (k - u) // 2) in PyTorch's own
semantics, MRF fusion of ResBlock1 (V1/V2) or ResBlock2 (V3) branches,
leaky ReLU 0.1 inside the network and PyTorch's default 0.01 before
`conv_post`, then tanh. Module names follow the reference checkpoint layout
(conv_pre / ups.N / resblocks.M.convs1|convs2|convs.J / conv_post) that
`visual_onoma_to_wave_tpu/models/hifigan.py::convert_torch_state_dict` reads.
On the card every ResBlock1 stage (V1, V2) is one launch of the fused MRF
kernel (`ops/mrf.py`, `csrc/mrf.cu`), which beat the cuDNN chain at all four
V1 stage shapes (PERF.md); ResBlock2 stages (V3), every stage on the CPU and
every stage of a generator in `.train()` (the kernel has no backward; GAN
training takes the plain chain, as the reference's takes XLA) run through
the modules.

`dtype` is the compute dtype (the JAX generators' field): in bfloat16
conv_pre, the upsampling and every MRF stage compute in bf16 with fp32
parameters (`precision.at_dtype`; on the card B2's bf16 instantiation), and
conv_post and tanh in fp32 on the bf16 trunk's output cast up, so the
waveform leaves in fp32 (JAX hifigan.py:36-67, :76-113, :146-183).

`receptive_halo_frames` is the generator's one-sided receptive field in mel
frames; `vocoder_infer_chunked` vocodes long or streamed mels in bounded
memory through any generator with a known halo (HiFi-GAN, iSTFTNet, Vocos,
BigVGAN), sample-exact against the full forward away from the true edges.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from visual_onoma_to_wave_tpu_torch.ops.mrf import MRFStages
from visual_onoma_to_wave_tpu_torch.precision import at_dtype, leaky_relu

LRELU_SLOPE = 0.1

# official size presets (hifi-gan config_v{1,2,3}.json)
HIFIGAN_PRESETS = {
    "v1": {},
    "v2": {"upsample_initial_channel": 128},
    "v3": {
        "resblock_type": "2",
        "upsample_rates": (8, 8, 4),
        "upsample_kernel_sizes": (16, 16, 8),
        "upsample_initial_channel": 256,
        "resblock_kernel_sizes": (3, 5, 7),
        "resblock_dilations": ((1, 2), (2, 6), (3, 12)),
    },
}


def _conv(c: int, k: int, d: int) -> nn.Conv1d:
    return nn.Conv1d(c, c, k, dilation=d, padding=d * (k - 1) // 2)


class ResBlock1(nn.Module):
    """3x [lrelu -> dilated conv -> lrelu -> conv d=1 -> +x], in `dtype`."""

    def __init__(self, channels: int, kernel_size: int, dilations=(1, 3, 5),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convs1 = nn.ModuleList(_conv(channels, kernel_size, d) for d in dilations)
        self.convs2 = nn.ModuleList(_conv(channels, kernel_size, 1) for _ in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            h = at_dtype(c1, leaky_relu(x, LRELU_SLOPE), self.dtype)
            x = x + at_dtype(c2, leaky_relu(h, LRELU_SLOPE), self.dtype)
        return x


class ResBlock2(nn.Module):
    """2x [lrelu -> dilated conv -> +x] (config_v3.json), in `dtype`."""

    def __init__(self, channels: int, kernel_size: int, dilations=(1, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.convs = nn.ModuleList(_conv(channels, kernel_size, d) for d in dilations)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = x + at_dtype(c, leaky_relu(x, LRELU_SLOPE), self.dtype)
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                 upsample_initial_channel: int = 512, resblock_kernel_sizes=(3, 7, 11),
                 resblock_dilations=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                 resblock_type: str = "1", n_mels: int = 80,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        # the architecture fields `receptive_halo_frames` reads
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernel_sizes = tuple(upsample_kernel_sizes)
        self.resblock_kernel_sizes = tuple(resblock_kernel_sizes)
        self.resblock_dilations = tuple(tuple(d) for d in resblock_dilations)
        self.resblock_type = resblock_type
        ch0 = upsample_initial_channel
        self.num_kernels = len(resblock_kernel_sizes)
        self.conv_pre = nn.Conv1d(n_mels, ch0, 7, padding=3)
        self.ups = nn.ModuleList(
            nn.ConvTranspose1d(ch0 // 2 ** i, ch0 // 2 ** (i + 1), k, stride=u,
                               padding=(k - u) // 2)
            for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)))
        block = ResBlock2 if resblock_type == "2" else ResBlock1
        self.resblocks = nn.ModuleList(
            block(ch0 // 2 ** (i + 1), rk, tuple(rd), dtype)
            for i in range(len(upsample_rates))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilations))
        self.conv_post = nn.Conv1d(ch0 // 2 ** len(upsample_rates), 1, 7, padding=3)
        self._mrf = (None if resblock_type == "2"
                     else MRFStages(resblock_kernel_sizes, resblock_dilations))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = at_dtype(self.conv_pre, mel.transpose(1, 2), self.dtype)
        n = self.num_kernels
        for i, up in enumerate(self.ups):
            x = at_dtype(up, leaky_relu(x, LRELU_SLOPE), self.dtype)
            blocks = self.resblocks[i * n:(i + 1) * n]
            if self._mrf is not None:
                x = self._mrf(i, blocks, x, fused=not self.training)
                continue
            acc = None
            for block in blocks:
                y = block(x)
                acc = y if acc is None else acc + y
            x = acc / n
        x = self.conv_post(leaky_relu(x, 0.01).float())  # PyTorch's default slope; fp32
        return torch.tanh(x)[:, 0, :]


def receptive_halo_frames(upsample_rates=(8, 8, 2, 2), upsample_kernel_sizes=(16, 16, 4, 4),
                          resblock_kernel_sizes=(3, 7, 11),
                          resblock_dilations=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
                          pre_kernel: int = 7, post_kernel: int = 7,
                          resblock_type: str = "1", aa_span: int = 0) -> int:
    """One-sided receptive field of a HiFi-GAN generator in input mel frames:
    a frame's output samples depend on at most this many frames on each
    side, so chunked vocoding with this halo is sample-exact away from the
    true edges. Per stage, from the output back: the MRF half-span at the
    stage's rate (ResBlock1: (d + 1)(k - 1) / 2 per unit; ResBlock2:
    d (k - 1) / 2), then the transposed conv's span moved to the input rate.
    `aa_span` (BigVGAN): the samples each anti-aliased activation adds at its
    own rate, once before `conv_post` and twice per ResBlock1 unit."""
    second_conv = 0 if resblock_type == "2" else 1     # ResBlock1's d=1 conv per unit
    halo = (post_kernel - 1) // 2 + aa_span
    for u, k in zip(reversed(upsample_rates), reversed(upsample_kernel_sizes)):
        halo += max(sum((d + second_conv) * (rk - 1) // 2 + 2 * aa_span for d in rd)
                    for rk, rd in zip(resblock_kernel_sizes, resblock_dilations))
        pad = (k - u) // 2
        halo = -(-(halo + k - 1 - pad) // u)
    return halo + (pre_kernel - 1) // 2


def generator_halo_frames(gen: nn.Module) -> int:
    """The generator's own `receptive_halo_frames` (iSTFTNet, Vocos, BigVGAN),
    else, for HiFi-GAN, the function of its fields. A generator with neither
    (MelGAN: the reference has no halo for it) raises ValueError."""
    if hasattr(gen, "receptive_halo_frames"):
        return gen.receptive_halo_frames()
    if isinstance(gen, HiFiGANGenerator):
        return receptive_halo_frames(gen.upsample_rates, gen.upsample_kernel_sizes,
                                     gen.resblock_kernel_sizes, gen.resblock_dilations,
                                     resblock_type=gen.resblock_type)
    raise ValueError(f"chunked vocoding needs the generator's receptive halo, and "
                     f"{type(gen).__name__} has none (HiFi-GAN, iSTFTNet, Vocos and BigVGAN "
                     "have one)")


@torch.inference_mode()
def vocoder_infer_chunked(gen: nn.Module, mel: torch.Tensor, chunk_frames: int = 256,
                          halo_frames: int | None = None) -> torch.Tensor:
    """(B, T, M) mels -> (B, T * hop) waveforms in bounded memory: the mels,
    zero-padded by `halo_frames` (default: the generator's receptive halo)
    on each side and to a whole number of chunks, are cut into overlapping
    windows of chunk_frames + 2 * halo_frames, vocoded as one batch of
    B * n_chunks windows, and the centre chunk_frames * hop samples of each
    are stitched. Sample-exact against the full forward away from the true
    edges, where the two see different padding."""
    halo = generator_halo_frames(gen)       # raises for a family without a halo
    if halo_frames is not None:
        halo = halo_frames
    b, t, m = mel.shape
    n_chunks = -(-t // chunk_frames)
    t_pad = n_chunks * chunk_frames
    padded = F.pad(mel, (0, 0, halo, t_pad - t + halo))
    win = chunk_frames + 2 * halo
    idx = (torch.arange(n_chunks, device=mel.device)[:, None] * chunk_frames
           + torch.arange(win, device=mel.device)[None, :])            # (N, win)
    windows = padded[:, idx, :]                                        # (B, N, win, M)
    wav = gen(windows.reshape(b * n_chunks, win, m))
    hop = wav.shape[-1] // win
    core = wav.reshape(b, n_chunks, win * hop)[:, :, halo * hop:(halo + chunk_frames) * hop]
    return core.reshape(b, t_pad * hop)[:, :t * hop]
