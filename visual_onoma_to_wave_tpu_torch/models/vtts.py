"""vTTS acoustic model (port of visual_onoma_to_wave_tpu/models/vtts.py).

Encoder (VFE or token embedding + FFT stack) -> audiotype embedding ->
VarianceAdaptor -> decoder FFT stack -> mel_linear -> PostNet. Module names
follow the reference state_dict layout that
`visual_onoma_to_wave_tpu/models/convert_acoustic.py` reads, so that
converter is the inverse of `bridge.vtts_state_dict`. `.train()` /
`.eval()` are the reference's `deterministic=False` / `True`
(`models/layers.py`); the forward takes the teacher-forcing targets of
training and of the eval step.

`dtype` is the compute dtype (`train.compute_dtype` through `from_config`):
in bfloat16 the encoder and decoder FFT stacks and the PostNet compute in
bf16 (`models/layers.py`), while the VFE, the embeddings, the variance
adaptor and `mel_linear` compute in fp32 on fp32 inputs, and the parameters
stay fp32, as in the JAX model (its vtts.py:205-253).
"""
from __future__ import annotations

import torch
from torch import nn

from visual_onoma_to_wave_tpu_torch.models.layers import (
    FFTBlock,
    PostNet,
    init_like_flax,
    sinusoid_position_table,
)
from visual_onoma_to_wave_tpu_torch.models.variance_adaptor import VarianceAdaptor
from visual_onoma_to_wave_tpu_torch.models.vfe import VisualFeatureExtractor
from visual_onoma_to_wave_tpu_torch.ops.length_regulator import get_mask_from_lengths
from visual_onoma_to_wave_tpu_torch.precision import compute_dtype


class _PositionTable(nn.Module):
    """Sinusoid table of max_seq_len + 1 rows, re-made longer on demand."""

    def __init__(self, max_seq_len: int, d_hid: int):
        super().__init__()
        self.d_hid = d_hid
        self.register_buffer("table", torch.from_numpy(
            sinusoid_position_table(max_seq_len + 1, d_hid)), persistent=False)

    def forward(self, length: int) -> torch.Tensor:
        if length > self.table.shape[0]:
            return torch.from_numpy(sinusoid_position_table(length, self.d_hid)).to(
                self.table.device)
        return self.table[:length]


class FFTStack(nn.Module):
    """A stack of FFT blocks sharing one padding mask (`layer_stack.{i}`)."""

    def __init__(self, n_layers: int, d_model: int, n_head: int, d_inner: int,
                 kernel_size, dropout: float = 0.2, dtype: torch.dtype = torch.float32):
        super().__init__()
        d_k = d_model // n_head
        self.layer_stack = nn.ModuleList(
            FFTBlock(d_model, n_head, d_k, d_k, d_inner, kernel_size, dropout, dtype)
            for _ in range(n_layers))

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        for layer in self.layer_stack:
            x = layer(x, pad_mask)
        return x


class Encoder(FFTStack):
    """Encoder FFT stack plus its input embedding: the visual feature
    extractor (`VisualFeatureExtractor`) or the token table (`src_word_emb`)."""

    def __init__(self, n_vocab: int, use_image: bool, vfe: dict, **stack):
        super().__init__(**stack)
        if use_image:
            self.VisualFeatureExtractor = VisualFeatureExtractor(**vfe)
        else:
            self.src_word_emb = nn.Embedding(n_vocab + 1, stack["d_model"])


class VTTS(nn.Module):
    """Full acoustic model; build with `VTTS.from_config(config, metadata, n_vocab)`.

    A model built with use_image=True embeds image cells, otherwise token
    ids. Parameters start from flax's initialisers (`layers.init_like_flax`,
    the VFE's U(-0.08, 0.08)), drawn from torch's global RNG. The PostNet's
    dropout rate is not in the config (the reference fixes it at 0.5).
    """

    def __init__(self, n_vocab: int, n_audiotype: int, hidden: int = 256,
                 encoder_layers: int = 4, decoder_layers: int = 6, n_head: int = 2,
                 decoder_n_head: int | None = None, d_inner: int = 1024,
                 ffn_kernel=(9, 1), max_seq_len: int = 1000, max_mel_len: int = 1000,
                 n_mels: int = 80, use_image: bool = True, vfe_kernel=(3, 3),
                 vfe_layers: int = 3, vfe_channels: int = 1, cell_hw=(24, 102),
                 n_bins: int = 256, vp_filter: int = 256, vp_kernel: int = 3,
                 is_energy: bool = True, is_kurtosis: bool = False,
                 energy_quantization: str = "linear", kurtosis_quantization: str = "linear",
                 energy_stats=(-1.0, 1.0, 0.0, 1.0), kurtosis_stats=(-1.0, 1.0, 0.0, 1.0),
                 multi_audiotype: bool = True, postnet_dim: int = 512,
                 encoder_dropout: float = 0.2, decoder_dropout: float = 0.2,
                 vp_dropout: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.use_image = use_image
        self.max_mel_len = max_mel_len
        self.encoder = Encoder(
            n_vocab, use_image,
            vfe=dict(embed_dim=hidden, cell_hw=tuple(cell_hw), kernel_size=tuple(vfe_kernel),
                     num_convolutions=vfe_layers, channels=vfe_channels),
            n_layers=encoder_layers, d_model=hidden, n_head=n_head, d_inner=d_inner,
            kernel_size=tuple(ffn_kernel), dropout=encoder_dropout, dtype=dtype)
        self.audiotype_emb = nn.Embedding(n_audiotype, hidden) if multi_audiotype else None
        self.variance_adaptor = VarianceAdaptor(
            hidden=hidden, n_bins=n_bins, filter_size=vp_filter, kernel_size=vp_kernel,
            is_energy=is_energy, is_kurtosis=is_kurtosis,
            energy_quantization=energy_quantization,
            kurtosis_quantization=kurtosis_quantization,
            energy_stats=energy_stats, kurtosis_stats=kurtosis_stats,
            max_mel_len=max_mel_len, dropout=vp_dropout)
        self.decoder = FFTStack(decoder_layers, hidden, decoder_n_head or n_head, d_inner,
                                tuple(ffn_kernel), decoder_dropout, dtype)
        self.mel_linear = nn.Linear(hidden, n_mels)
        self.postnet = PostNet(n_mels, postnet_dim, dtype=dtype)
        self.position = _PositionTable(max_seq_len, hidden)
        vfe = [self.encoder.VisualFeatureExtractor] if use_image else []
        init_like_flax(self, skip=vfe)
        for m in vfe:
            m.init_uniform()

    @classmethod
    def from_config(cls, config, metadata=None, n_vocab: int = 64,
                    max_mel_len: int | None = None) -> "VTTS":
        """The reference's `VTTS.from_config` on the port's `config.Config` (read
        by attribute; this module does not import it). `model.fused_attention`
        is ignored: every attention call takes `ops.attention.attention_core`.
        `train.compute_dtype` "bfloat16" / "bf16" gives a bf16 model, anything
        else fp32 (`precision.compute_dtype`)."""
        m, t = config.model, config.model.transformer
        if t.decoder_hidden != t.encoder_hidden:
            raise ValueError(f"decoder_hidden ({t.decoder_hidden}) must equal "
                             f"encoder_hidden ({t.encoder_hidden})")
        kwargs = dict(
            n_vocab=n_vocab,
            n_audiotype=metadata.n_audiotype if metadata else 10,
            hidden=t.encoder_hidden, encoder_layers=t.encoder_layer,
            decoder_layers=t.decoder_layer, n_head=t.encoder_head,
            decoder_n_head=t.decoder_head, d_inner=t.conv_filter_size,
            ffn_kernel=tuple(t.conv_kernel_size), max_seq_len=m.max_seq_len,
            max_mel_len=max_mel_len or config.train.max_mel_len,
            n_mels=config.audio.mel.n_mel_channels, use_image=config.train.use_image,
            vfe_kernel=tuple(m.visual_feature_extractor.conv_kernel_size),
            vfe_layers=m.visual_feature_extractor.layer_num,
            vfe_channels=3 if config.visual_text.scale_in_training == "RGB-scale" else 1,
            n_bins=m.variance_embedding.n_bins, vp_filter=m.variance_predictor.filter_size,
            vp_kernel=m.variance_predictor.kernel_size,
            is_energy=m.variance_embedding.is_energy_condition,
            is_kurtosis=m.variance_embedding.is_kurtosis_condition,
            energy_quantization=m.variance_embedding.energy_quantization,
            kurtosis_quantization=m.variance_embedding.kurtosis_quantization,
            multi_audiotype=m.multi_audiotype, postnet_dim=m.postnet_channels,
            encoder_dropout=t.encoder_dropout, decoder_dropout=t.decoder_dropout,
            vp_dropout=m.variance_predictor.dropout,
            dtype=compute_dtype(config.train.compute_dtype))
        if metadata is not None:
            kwargs["cell_hw"] = (metadata.image_height, metadata.max_pixelsize)
            e, k = metadata.energy_stats, metadata.kurtosis_stats
            kwargs["energy_stats"] = (e.min, e.max, e.mean, e.std)
            kwargs["kurtosis_stats"] = (k.min, k.max, k.mean, k.std)
        return cls(**kwargs)

    def forward(self, audiotypes: torch.Tensor, texts: torch.Tensor, src_lens: torch.Tensor,
                image_cells: torch.Tensor | None = None, e_control=1.0, d_control=1.0,
                max_mel_len: int | None = None, energy_targets: torch.Tensor | None = None,
                kurtosis_targets: torch.Tensor | None = None,
                duration_targets: torch.Tensor | None = None) -> dict:
        """audiotypes (B,), texts (B, C) 0-padded ids, src_lens (B,), image_cells
        (B, C, H, Wc) in [0, 1]; controls are scalars or per-item (B,). The
        (B, C) targets teacher-force the variance adaptor; in training
        max_mel_len is the batch's padded mel length."""
        B, C = texts.shape
        src_pad_mask = get_mask_from_lengths(src_lens, C)
        enc = self.encoder
        if self.use_image:
            emb = enc.VisualFeatureExtractor(image_cells)
        else:
            emb = enc.src_word_emb(texts)
        x = enc(emb + self.position(C)[None], src_pad_mask)
        if self.audiotype_emb is not None:
            x = x + self.audiotype_emb(audiotypes)[:, None, :]

        (x, e_pred, k_pred, log_d_pred, d_rounded, mel_len,
         mel_pad_mask) = self.variance_adaptor(x, src_pad_mask, e_control, d_control,
                                               max_mel_len, energy_targets, kurtosis_targets,
                                               duration_targets)
        x = self.decoder(x + self.position(x.shape[1])[None], mel_pad_mask)
        mel = self.mel_linear(x.float())
        return {
            "mel": mel,
            "postnet_mel": mel + self.postnet(mel),
            "energy_pred": e_pred,
            "kurtosis_pred": k_pred,
            "log_duration_pred": log_d_pred,
            "duration_rounded": d_rounded,
            "src_pad_mask": src_pad_mask,
            "mel_pad_mask": mel_pad_mask,
            "src_lens": src_lens,
            "mel_lens": mel_len,
        }
