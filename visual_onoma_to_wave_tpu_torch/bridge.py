"""Weight bridge: JAX/flax parameter trees (as numpy) -> PyTorch state_dicts.

The inverse of the reference converters
`visual_onoma_to_wave_tpu/models/convert_acoustic.py::convert_vtts_state_dict`,
`visual_onoma_to_wave_tpu/models/hifigan.py::convert_torch_state_dict` and
`visual_onoma_to_wave_tpu/models/melgan.py::convert_melgan_state_dict`:
those read the reference PyTorch layout into flax trees, these write flax
trees back into it, so `convert(bridge(tree)) == tree`. The iSTFTNet trees
share HiFi-GAN's names (conv_pre, up_i, resblock_i_j, conv_post).

    flax nn.Dense kernel (in, out)         -> Linear.weight (out, in)
    flax nn.Conv kernel (K, Cin, Cout)     -> Conv1d.weight (Cout, Cin, K)
    VFE conv kernel (kh, kw, Cin, Cout)    -> Conv2d.weight (Cout, Cin, kh, kw)
    VFE bridge kernel, rows in (h, w, c)   -> Linear.weight, columns in (c, h, w)
    BatchNorm scale/bias + batch_stats     -> weight/bias, running_mean/var
    LayerNorm scale/bias                   -> weight/bias
    nn.Embed embedding                     -> Embedding.weight
    HiFi-GAN up_i_w, flipped (K, Cin, Cout) -> ConvTranspose1d.weight (Cin, Cout, K)
    MelGAN conv_pre / up_i / resblock_i_j / conv_post -> model.{idx}[.block.2|.block.4|.shortcut]
    Vocos params/<name>, params/block_i/<name> -> <name>, blocks.i.<name>,
                                              same shape (no reference layout)
    BigVGAN conv_pre / up_i / conv_post       -> as HiFi-GAN's
    BigVGAN amp_i_j/convs{1,2}_k              -> resblocks.{i*n+j}.convs{1,2}.k
    BigVGAN amp_i_j/act{1,2}_k/log_alpha|log_beta, act_post/...
                                              -> resblocks.r.acts{1,2}.k.<leaf>, act_post.<leaf>

    discriminators params/<sub>/WNConv_i/{v,g,b} -> <sub>.convs.i.{v,g,b},
      v (kh[, kw], Cin/groups, Cout)             -> (Cout, Cin/groups, kh[, kw])

Trees travel between the frameworks as `.npz` files keyed by the
'/'-joined flax path ("params/encoder/layer_0/slf_attn/w_qs/kernel").
Every leaf must be consumed; a leaf the bridge does not know raises.
`vtts_tree` is the inverse of `vtts_state_dict`: the port's trainer writes
its checkpoints through it, in the flax layout the Synthesizer reads.
`vocoder_tree` is the inverse of `vocoder_state_dict` for every family
`cli train-vocoder` trains (HiFi-GAN, iSTFTNet, Vocos, BigVGAN): the port's
GAN trainer writes its generators through it, as the `.npz` trees that
`synthesis.load_vocoder` reads.
"""
from __future__ import annotations

import pathlib
import re

import numpy as np
import torch

from visual_onoma_to_wave_tpu_torch.models.vocoder import family as vocoder_family


def flatten_tree(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict -> {'a/b/c': array}."""
    flat = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(flatten_tree(v, path + "/"))
        else:
            flat[path] = np.asarray(v)
    return flat


def unflatten_tree(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_npz(path: str | pathlib.Path, tree: dict) -> None:
    np.savez(path, **flatten_tree(tree))


def load_npz(path: str | pathlib.Path) -> dict:
    with np.load(path) as f:
        return unflatten_tree({k: f[k] for k in f.files})


class _Leaves:
    """Pops leaves by flax path; `finish` raises on any leaf left over."""

    def __init__(self, tree: dict):
        self.flat = flatten_tree(tree)

    def take(self, path: str) -> torch.Tensor:
        try:
            return torch.from_numpy(np.array(self.flat.pop(path), dtype=np.float32))
        except KeyError:
            raise KeyError(f"flax tree has no leaf {path!r}") from None

    def groups(self, root: str) -> list[str]:
        """Distinct parent paths of the leaves under `root`, in sorted order."""
        parents = {p.rsplit("/", 1)[0] for p in self.flat if p.startswith(root + "/")}
        return sorted(parents - {root})

    def finish(self) -> None:
        if self.flat:
            raise ValueError(f"bridge left {len(self.flat)} flax leaves unmapped: "
                             f"{sorted(self.flat)[:8]}")


# flax module path (under params/ or batch_stats/) -> reference PyTorch prefix
_ACOUSTIC_RENAMES = [
    (r"^(encoder|decoder)/layer_(\d+)/", r"\1.layer_stack.\2."),
    (r"^vfe/conv_(\d+)$", lambda m: f"encoder.VisualFeatureExtractor.embedder.{3 * int(m[1])}"),
    (r"^vfe/bn_(\d+)$", lambda m: f"encoder.VisualFeatureExtractor.embedder.{3 * int(m[1]) + 1}"),
    (r"^vfe/bridge$", "encoder.VisualFeatureExtractor.bridge.0"),
    (r"^src_word_emb$", "encoder.src_word_emb"),
    (r"_predictor/(conv1d_\d)$", r"_predictor/conv_layer/\1/conv"),
    (r"_predictor/(layer_norm_\d)$", r"_predictor/conv_layer/\1"),
    (r"^postnet/conv_(\d+)$", r"postnet.convolutions.\1.0.conv"),
    (r"^postnet/bn_(\d+)$", r"postnet.convolutions.\1.1"),
]


def _torch_prefix(flax_path: str) -> str:
    for pattern, repl in _ACOUSTIC_RENAMES:
        flax_path = re.sub(pattern, repl, flax_path)
    return flax_path.replace("/", ".")


def vtts_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """{"params", "batch_stats"} of the JAX `VTTS` -> state_dict of the port's `VTTS`."""
    leaves = _Leaves(variables)
    sd: dict[str, torch.Tensor] = {}
    conv0 = leaves.flat.get("params/vfe/conv_0/kernel")
    vfe_channels = conv0.shape[3] if conv0 is not None else 1
    for group in leaves.groups("params"):
        module = group.removeprefix("params/")
        out = _torch_prefix(module)
        names = {p.rsplit("/", 1)[1] for p in leaves.flat if p.rsplit("/", 1)[0] == group}
        if "embedding" in names:
            sd[f"{out}.weight"] = leaves.take(f"{group}/embedding")
        elif "kernel" in names:
            k = leaves.take(f"{group}/kernel")
            if module == "vfe/bridge" and vfe_channels > 1:
                # rows (h, w, c) -> (c, h, w): the reference flattens NCHW
                hw = k.shape[0] // vfe_channels
                k = k.reshape(hw, vfe_channels, -1).transpose(0, 1).reshape(k.shape[0], -1)
            if k.ndim == 2:      # Dense (in, out) -> Linear (out, in)
                w = k.T
            elif k.ndim == 3:    # Conv (K, Cin, Cout) -> Conv1d (Cout, Cin, K)
                w = k.permute(2, 1, 0)
            else:                # Conv (kh, kw, Cin, Cout) -> Conv2d (Cout, Cin, kh, kw)
                w = k.permute(3, 2, 0, 1)
            sd[f"{out}.weight"] = w.contiguous()
            sd[f"{out}.bias"] = leaves.take(f"{group}/bias")
        elif names == {"scale", "bias"}:
            sd[f"{out}.weight"] = leaves.take(f"{group}/scale")
            sd[f"{out}.bias"] = leaves.take(f"{group}/bias")
            stats = f"batch_stats/{module}"
            if f"{stats}/mean" in leaves.flat:
                sd[f"{out}.running_mean"] = leaves.take(f"{stats}/mean")
                sd[f"{out}.running_var"] = leaves.take(f"{stats}/var")
                sd[f"{out}.num_batches_tracked"] = torch.tensor(0)
        else:
            raise ValueError(f"bridge: unknown flax module {group!r} with leaves {sorted(names)}")
    leaves.finish()
    return sd


# reference PyTorch prefix -> flax module path: `_ACOUSTIC_RENAMES` backwards
_ACOUSTIC_TREE_RENAMES = [
    (r"^(encoder|decoder)\.layer_stack\.(\d+)\.", r"\1/layer_\2/"),
    (r"^encoder\.VisualFeatureExtractor\.embedder\.(\d+)$",
     lambda m: f"vfe/{'conv' if int(m[1]) % 3 == 0 else 'bn'}_{int(m[1]) // 3}"),
    (r"^encoder\.VisualFeatureExtractor\.bridge\.0$", "vfe/bridge"),
    (r"^encoder\.src_word_emb$", "src_word_emb"),
    (r"_predictor\.conv_layer\.(conv1d_\d)\.conv$", r"_predictor/\1"),
    (r"_predictor\.conv_layer\.(layer_norm_\d)$", r"_predictor/\1"),
    (r"^postnet\.convolutions\.(\d+)\.0\.conv$", r"postnet/conv_\1"),
    (r"^postnet\.convolutions\.(\d+)\.1$", r"postnet/bn_\1"),
]


def _flax_module(torch_prefix: str) -> str:
    for pattern, repl in _ACOUSTIC_TREE_RENAMES:
        torch_prefix = re.sub(pattern, repl, torch_prefix)
    return torch_prefix.replace(".", "/")


def vtts_tree(state_dict: dict[str, torch.Tensor]) -> dict:
    """state_dict of the port's `VTTS` -> {"params", "batch_stats"} of the JAX
    `VTTS` as numpy arrays: the inverse of `vtts_state_dict`."""
    sd = {k: v.detach().cpu() for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    flat: dict[str, np.ndarray] = {}
    conv0 = sd.get("encoder.VisualFeatureExtractor.embedder.0.weight")
    vfe_channels = conv0.shape[0] if conv0 is not None else 1
    for out in sorted({k.rsplit(".", 1)[0] for k in sd}):
        module = _flax_module(out)
        w = sd.pop(f"{out}.weight")
        if f"{out}.running_mean" in sd:          # BatchNorm
            flat[f"params/{module}/scale"] = w
            flat[f"params/{module}/bias"] = sd.pop(f"{out}.bias")
            flat[f"batch_stats/{module}/mean"] = sd.pop(f"{out}.running_mean")
            flat[f"batch_stats/{module}/var"] = sd.pop(f"{out}.running_var")
        elif f"{out}.bias" not in sd:            # Embedding
            flat[f"params/{module}/embedding"] = w
        elif w.ndim == 1:                        # LayerNorm
            flat[f"params/{module}/scale"] = w
            flat[f"params/{module}/bias"] = sd.pop(f"{out}.bias")
        else:
            if w.ndim == 2:      # Linear (out, in) -> Dense (in, out)
                k = w.T
                if module == "vfe/bridge" and vfe_channels > 1:
                    # rows (c, h, w) -> (h, w, c): flax flattens NHWC
                    hw = k.shape[0] // vfe_channels
                    k = k.reshape(vfe_channels, hw, -1).transpose(0, 1).reshape(k.shape[0], -1)
            elif w.ndim == 3:    # Conv1d (Cout, Cin, K) -> Conv (K, Cin, Cout)
                k = w.permute(2, 1, 0)
            else:                # Conv2d (Cout, Cin, kh, kw) -> Conv (kh, kw, Cin, Cout)
                k = w.permute(2, 3, 1, 0)
            flat[f"params/{module}/kernel"] = k
            flat[f"params/{module}/bias"] = sd.pop(f"{out}.bias")
    if sd:
        raise ValueError(f"vtts_tree left {len(sd)} tensors unmapped: {sorted(sd)[:8]}")
    return unflatten_tree({k: np.ascontiguousarray(v.numpy()) for k, v in flat.items()})


def hifigan_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """{"params"} of the JAX `HiFiGANGenerator` -> state_dict of the port's generator."""
    leaves = _Leaves(variables)
    sd: dict[str, torch.Tensor] = {}

    def conv(flax_prefix: str, out: str) -> None:
        sd[f"{out}.weight"] = leaves.take(f"{flax_prefix}_w").permute(2, 1, 0).contiguous()
        sd[f"{out}.bias"] = leaves.take(f"{flax_prefix}_b")

    conv("params/conv_pre", "conv_pre")
    blocks = [g.removeprefix("params/") for g in leaves.groups("params")]
    n_kernels = 1 + max(int(b.split("_")[2]) for b in blocks)
    i = 0
    while f"params/up_{i}_w" in leaves.flat:
        # stored flipped as (K, Cin, Cout): un-flip K into (Cin, Cout, K)
        w = leaves.take(f"params/up_{i}_w")
        sd[f"ups.{i}.weight"] = w.permute(1, 2, 0).flip(-1).contiguous()
        sd[f"ups.{i}.bias"] = leaves.take(f"params/up_{i}_b")
        i += 1
    for b in blocks:
        _, si, sj = b.split("_")
        r = int(si) * n_kernels + int(sj)
        for leaf in sorted(p for p in list(leaves.flat) if p.startswith(f"params/{b}/")):
            if not leaf.endswith("_w"):
                continue
            name, di, _ = leaf.rsplit("/", 1)[1].rsplit("_", 2)   # convs1_0_w
            conv(leaf[:-2], f"resblocks.{r}.{name}.{di}")
    conv("params/conv_post", "conv_post")
    leaves.finish()
    return sd


# Vocos leaves: every one keeps its flax name and shape in the port's module
_VOCOS_TOP = ("embed_w", "embed_b", "norm_in_scale", "norm_in_bias", "norm_out_scale",
              "norm_out_bias", "head_w", "head_b")
_VOCOS_BLOCK = ("dwconv_w", "dwconv_b", "norm_scale", "norm_bias", "pw1_w", "pw1_b", "pw2_w",
                "pw2_b", "gamma")


def vocos_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """{"params"} of the JAX `VocosGenerator` -> state_dict of the port's:
    params/<name> -> <name>, params/block_<i>/<name> -> blocks.<i>.<name>."""
    leaves = _Leaves(variables)
    sd: dict[str, torch.Tensor] = {}
    for path in sorted(leaves.flat):
        parts = path.split("/")
        if parts[0] == "params" and len(parts) == 2 and parts[1] in _VOCOS_TOP:
            sd[parts[1]] = leaves.take(path)
        elif (parts[0] == "params" and len(parts) == 3 and re.fullmatch(r"block_\d+", parts[1])
              and parts[2] in _VOCOS_BLOCK):
            sd[f"blocks.{parts[1][6:]}.{parts[2]}"] = leaves.take(path)
        else:
            raise ValueError(f"bridge: unknown Vocos leaf {path!r}")
    leaves.finish()
    return sd


def melgan_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """{"params"} of the JAX `MelGANGenerator` -> state_dict of the port's, in
    the melgan-neurips sequential layout: [pad, conv_pre] + per ratio [leaky,
    convT, resblock x n] + [leaky, pad, conv_post, tanh]."""
    leaves = _Leaves(variables)
    sd: dict[str, torch.Tensor] = {}

    def conv(flax_prefix: str, out: str) -> None:
        sd[f"{out}.weight"] = leaves.take(f"{flax_prefix}_w").permute(2, 1, 0).contiguous()
        sd[f"{out}.bias"] = leaves.take(f"{flax_prefix}_b")

    conv("params/conv_pre", "model.1")
    idx, i = 2, 0
    while f"params/up_{i}_w" in leaves.flat:
        idx += 1                                    # LeakyReLU
        w = leaves.take(f"params/up_{i}_w")         # flipped (K, Cin, Cout)
        sd[f"model.{idx}.weight"] = w.permute(1, 2, 0).flip(-1).contiguous()
        sd[f"model.{idx}.bias"] = leaves.take(f"params/up_{i}_b")
        idx += 1
        j = 0
        while f"params/resblock_{i}_{j}/conv1_w" in leaves.flat:
            blk = f"params/resblock_{i}_{j}"
            conv(f"{blk}/conv1", f"model.{idx}.block.2")
            conv(f"{blk}/conv2", f"model.{idx}.block.4")
            conv(f"{blk}/shortcut", f"model.{idx}.shortcut")
            idx, j = idx + 1, j + 1
        i += 1
    conv("params/conv_post", f"model.{idx + 2}")   # after LeakyReLU, ReflectionPad
    leaves.finish()
    return sd


def bigvgan_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """{"params"} of the JAX `BigVGANGenerator` -> state_dict of the port's.
    Convs and transposed convs as `hifigan_state_dict`; the snake
    parameters keep their names and shapes. Every leaf is consumed; one the
    BigVGAN layout does not have raises ValueError."""
    leaves = _Leaves(variables)
    amp = [re.match(r"params/amp_\d+_(\d+)/", p) for p in leaves.flat]
    n_kernels = 1 + max((int(m[1]) for m in amp if m), default=0)
    sd: dict[str, torch.Tensor] = {}
    for path in sorted(leaves.flat):
        if m := re.fullmatch(r"params/(conv_pre|conv_post)_([wb])", path):
            out = f"{m[1]}.{'weight' if m[2] == 'w' else 'bias'}"
        elif m := re.fullmatch(r"params/up_(\d+)_([wb])", path):
            out = f"ups.{m[1]}.{'weight' if m[2] == 'w' else 'bias'}"
        elif m := re.fullmatch(r"params/amp_(\d+)_(\d+)/(convs[12])_(\d+)_([wb])", path):
            r = int(m[1]) * n_kernels + int(m[2])
            out = f"resblocks.{r}.{m[3]}.{m[4]}.{'weight' if m[5] == 'w' else 'bias'}"
        elif m := re.fullmatch(r"params/amp_(\d+)_(\d+)/act([12])_(\d+)/(log_alpha|log_beta)",
                               path):
            r = int(m[1]) * n_kernels + int(m[2])
            out = f"resblocks.{r}.acts{m[3]}.{m[4]}.{m[5]}"
        elif m := re.fullmatch(r"params/act_post/(log_alpha|log_beta)", path):
            out = f"act_post.{m[1]}"
        else:
            raise ValueError(f"bridge: unknown BigVGAN leaf {path!r}")
        v = leaves.take(path)
        if path.startswith("params/up_") and path.endswith("_w"):
            v = v.permute(1, 2, 0).flip(-1)     # flipped (K, Cin, Cout) -> (Cin, Cout, K)
        elif out.endswith(".weight"):
            v = v.permute(2, 1, 0)              # (K, Cin, Cout) -> (Cout, Cin, K)
        sd[out] = v.contiguous()
    leaves.finish()
    return sd


def vocoder_state_dict(family: str, variables: dict) -> dict[str, torch.Tensor]:
    """The bridge of the configured vocoder family (`config.model.vocoder_model`)."""
    bridges = {"hifigan": hifigan_state_dict, "melgan": melgan_state_dict,
               "vocos": vocos_state_dict, "bigvgan": bigvgan_state_dict}
    return bridges[_vocoder_layout(family)](variables)


def _vocoder_layout(family: str) -> str:
    """The parameter layout of a family: iSTFTNet shares HiFi-GAN's."""
    name = vocoder_family(family)
    if name.startswith("hifigan") or name in ("istftnet", "istftnetmel"):
        return "hifigan"
    if name in ("vocos", "melgan"):
        return name
    if name in ("bigvgan", "bigvganbase", "bigvganlarge"):
        return "bigvgan"
    raise ValueError(f"unknown vocoder family: {family!r}")


def _stage_kernels(sd: dict) -> int:
    """Branches per MRF / AMP stage: the resblocks over the stages (one
    stage at mel rate when there is no upsampling)."""
    n_blocks = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("resblocks."))
    n_ups = len({k.split(".")[1] for k in sd if k.startswith("ups.")})
    return n_blocks // max(n_ups, 1)


def vocoder_tree(family: str, state_dict: dict[str, torch.Tensor]) -> dict:
    """state_dict of the port's generator of `family` -> {"params"} of the
    JAX generator as numpy arrays: the inverse of `vocoder_state_dict` for
    HiFi-GAN (V1-V3), iSTFTNet (both presets), Vocos and BigVGAN. A tensor
    the family's layout does not have raises ValueError."""
    layout = _vocoder_layout(family)
    if layout == "melgan":
        raise ValueError("MelGAN is served, not trained, by both packages: no vocoder_tree")
    sd = {k: v.detach().cpu().float() for k, v in state_dict.items()}
    n_kernels = _stage_kernels(sd) if layout != "vocos" else 0
    flat: dict[str, torch.Tensor] = {}
    for key in sorted(sd):
        v = sd[key]
        if layout == "vocos":
            if m := re.fullmatch(r"blocks\.(\d+)\.(\w+)", key):
                ok, path = m[2] in _VOCOS_BLOCK, f"params/block_{m[1]}/{m[2]}"
            else:
                ok, path = key in _VOCOS_TOP, f"params/{key}"
            if not ok:
                raise ValueError(f"vocoder_tree: unknown Vocos tensor {key!r}")
            flat[path] = v
            continue
        leaf = {"weight": "w", "bias": "b"}
        if m := re.fullmatch(r"(conv_pre|conv_post)\.(weight|bias)", key):
            path = f"params/{m[1]}_{leaf[m[2]]}"
        elif m := re.fullmatch(r"ups\.(\d+)\.(weight|bias)", key):
            path = f"params/up_{m[1]}_{leaf[m[2]]}"
            if m[2] == "weight":     # (Cin, Cout, K) -> flipped (K, Cin, Cout)
                v = v.flip(-1).permute(2, 0, 1)
        elif m := re.fullmatch(r"resblocks\.(\d+)\.(convs[12]?)\.(\d+)\.(weight|bias)", key):
            i, j = divmod(int(m[1]), n_kernels)
            block = f"amp_{i}_{j}" if layout == "bigvgan" else f"resblock_{i}_{j}"
            path = f"params/{block}/{m[2]}_{m[3]}_{leaf[m[4]]}"
        elif layout == "bigvgan" and (m := re.fullmatch(
                r"resblocks\.(\d+)\.acts([12])\.(\d+)\.(log_alpha|log_beta)", key)):
            i, j = divmod(int(m[1]), n_kernels)
            path = f"params/amp_{i}_{j}/act{m[2]}_{m[3]}/{m[4]}"
        elif layout == "bigvgan" and (m := re.fullmatch(r"act_post\.(log_alpha|log_beta)", key)):
            path = f"params/act_post/{m[1]}"
        else:
            raise ValueError(f"vocoder_tree: unknown {layout} tensor {key!r}")
        if path.endswith("_w") and not path.startswith("params/up_"):
            v = v.permute(2, 1, 0)          # (Cout, Cin, K) -> (K, Cin, Cout)
        flat[path] = v
    return unflatten_tree({k: np.ascontiguousarray(v.numpy()) for k, v in flat.items()})


_DISC_SUBS = {"mpd": r"p\d+", "msd": r"s\d+", "mrd": r"r\d+"}


def _disc_state_dict(variables: dict, kind: str) -> dict[str, torch.Tensor]:
    params = variables.get("params", variables)
    leaves = _Leaves(params)
    sd: dict[str, torch.Tensor] = {}
    for path in sorted(leaves.flat):
        m = re.fullmatch(rf"({_DISC_SUBS[kind]})/WNConv_(\d+)/([vgb])", path)
        if m is None:
            raise ValueError(f"bridge: unknown {kind.upper()} leaf {path!r}")
        v = leaves.take(path)
        if m[3] == "v":      # (kh[, kw], Cin/groups, Cout) -> (Cout, Cin/groups, kh[, kw])
            v = v.permute(v.ndim - 1, v.ndim - 2, *range(v.ndim - 2))
        sd[f"{m[1]}.convs.{m[2]}.{m[3]}"] = v.contiguous()
    leaves.finish()
    return sd


def mpd_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX `MultiPeriodDiscriminator`'s params ({"params": ...} or the
    tree under it) -> state_dict of the port's."""
    return _disc_state_dict(variables, "mpd")


def msd_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX `MultiScaleDiscriminator`'s params -> state_dict of the port's."""
    return _disc_state_dict(variables, "msd")


def mrd_state_dict(variables: dict) -> dict[str, torch.Tensor]:
    """The JAX `MultiResolutionDiscriminator`'s params -> state_dict of the port's."""
    return _disc_state_dict(variables, "mrd")
