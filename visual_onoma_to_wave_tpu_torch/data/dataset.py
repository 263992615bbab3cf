"""Training dataset + bucketed batching (copy of visual_onoma_to_wave_tpu/data/dataset.py).

Replaces reference scripts/dataset.py. Parity points:
  * metadata rows `name|audiotype|fontsize|font|text` (process_meta);
  * per-character image cells re-padded to the global max width, centered on
    a 255 background with the extra pixel on the LEFT (reference
    character_padding_forinput, dataset.py:71-92);
  * sort-by-length grouped batching: a pool of group_size*batch_size items is
    sorted by text length and sliced into batches (dataset.py:187-202).

Differences from the reference kept from the JAX package:
  * every batch is padded to (text, mel) BUCKET boundaries, a small, fixed
    set of shapes instead of one shape per batch;
  * images are returned as (B, C, H, cell_width) float32 cell tensors in
    [0, 1] — the model's VFE consumes cells directly (no Python slicing).

Batches are numpy dicts; `to_device` moves one onto the model's device.
The cells are cut by the host C kernel (`data/native.py::pad_cells_u8`)
when a C compiler builds it, as in the JAX package, else by its numpy twin
`pad_character_cells`; the two are equal bit for bit.
"""
from __future__ import annotations

import pathlib
from dataclasses import dataclass

import numpy as np
from PIL import Image

from visual_onoma_to_wave_tpu_torch.config import Config, DatasetMetadata
from visual_onoma_to_wave_tpu_torch.data.symbols import build_symbol_map, encode_text


def pad_character_cells(img: np.ndarray, char_widths: np.ndarray,
                        cell_width: int) -> np.ndarray:
    """(H, W_total) grayscale strip -> (n_chars, H, cell_width) cells, each
    character centered on 255 with ceil-left/floor-right padding."""
    H = img.shape[0]
    n = len(char_widths)
    out = np.full((n, H, cell_width), 255, dtype=img.dtype)
    x = 0
    for i, w in enumerate(char_widths):
        w = int(w)
        seg = img[:, x : x + w]
        if w > cell_width:          # defensive: clip over-wide glyphs
            seg = seg[:, :cell_width]
            w = cell_width
        left = (cell_width - w) // 2 + (cell_width - w) % 2
        out[i, :, left : left + seg.shape[1]] = seg
        x += int(char_widths[i])
    return out


def _pad_cells(img: np.ndarray, widths: np.ndarray, cell_width: int) -> np.ndarray:
    from visual_onoma_to_wave_tpu_torch.data import native

    if native.available():
        return native.pad_cells_u8(img, widths, cell_width)
    return pad_character_cells(img, widths, cell_width)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class Sample:
    basename: str
    audiotype_id: int
    text_ids: np.ndarray
    mel: np.ndarray             # (T, n_mels)
    energy: np.ndarray | None   # (C,)
    kurtosis: np.ndarray | None
    duration: np.ndarray        # (C,)
    cells: np.ndarray | None    # (C, H, cell_width) uint8


class OnomaDataset:
    def __init__(self, filename: str, config: Config,
                 sort: bool = False, drop_last: bool = False,
                 metadata: DatasetMetadata | None = None):
        self.config = config
        self.root = pathlib.Path(config.path.preprocessed)
        self.sort = sort
        self.drop_last = drop_last
        self.batch_size = config.train.optimizer.batch_size
        self.use_image = config.train.use_image
        self.is_energy = config.model.variance_embedding.is_energy_condition
        self.is_kurtosis = config.model.variance_embedding.is_kurtosis_condition
        self.metadata = metadata or DatasetMetadata.load(self.root)
        self.cell_width = self.metadata.max_pixelsize
        self.symbol_map = build_symbol_map(self.root)
        self.n_vocab = len(self.symbol_map)
        # text/mel padding buckets (multiples chosen to bound the batch shapes)
        self.text_bucket = 4
        self.mel_bucket = 128

        self.rows = []
        for line in (self.root / filename).read_text(encoding="utf-8").splitlines():
            if not line.strip():
                continue
            name, audiotype, fontsize, font, text = line.strip("\n").split("|")
            self.rows.append((name, audiotype, fontsize, font, text))

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, idx: int) -> Sample:
        name, audiotype, _, _, text = self.rows[idx]
        text_ids = np.asarray(encode_text(text, self.symbol_map), np.int32)
        mel = np.load(self.root / "mel" / audiotype / f"{name}.npy")
        duration = np.load(self.root / "duration" / audiotype / f"{name}.npy")
        energy = (np.load(self.root / "energy" / audiotype / f"{name}.npy")
                  if self.is_energy else None)
        kurtosis = (np.load(self.root / "kurtosis" / audiotype / f"{name}.npy")
                    if self.is_kurtosis else None)
        cells = None
        if self.use_image:
            widths = np.load(
                self.root / "image" / "width" / audiotype / f"{name}.npy"
            ).astype(np.int64)
            img = np.asarray(
                Image.open(self.root / "image" / "png" / audiotype / f"{name}.png")
                .convert("L"),
                dtype=np.uint8,
            )
            cells = _pad_cells(img, widths, self.cell_width)
        return Sample(
            basename=name,
            audiotype_id=self.metadata.audiotype_map[audiotype],
            text_ids=text_ids, mel=mel, energy=energy, kurtosis=kurtosis,
            duration=duration.astype(np.int32), cells=cells,
        )

    # ------------------------------------------------------------------
    def collate(self, samples: list[Sample],
                pad_to: tuple[int, int] | None = None) -> dict:
        """Pad a list of samples into one static-shaped batch dict.

        pad_to=(max_c, max_t) forces the pad targets instead of deriving
        them from the loaded samples — this is what lets a multi-host run
        collate only its local row slice of a batch while agreeing with
        every other host on the padded shapes (the targets come from
        `plan_pad_shapes`, metadata only)."""
        B = len(samples)
        if pad_to is not None:
            max_c, max_t = pad_to
        else:
            max_c = _round_up(max(len(s.text_ids) for s in samples),
                              self.text_bucket)
            max_t = min(_round_up(max(s.mel.shape[0] for s in samples),
                                  self.mel_bucket),
                        self.config.train.max_mel_len)
        mel_lens = np.array([s.mel.shape[0] for s in samples], np.int32)
        mel_lens = np.minimum(mel_lens, max_t)
        n_mels = samples[0].mel.shape[1]
        H = samples[0].cells.shape[1] if samples[0].cells is not None else 0

        texts = np.zeros((B, max_c), np.int32)
        durations = np.zeros((B, max_c), np.int32)
        energies = np.zeros((B, max_c), np.float32) if self.is_energy else None
        kurtoses = np.zeros((B, max_c), np.float32) if self.is_kurtosis else None
        mels = np.zeros((B, max_t, n_mels), np.float32)
        cells = (np.full((B, max_c, H, self.cell_width), 255, np.uint8)
                 if self.use_image else None)
        src_lens = np.zeros((B,), np.int32)
        audiotypes = np.zeros((B,), np.int32)
        names = []
        for i, s in enumerate(samples):
            c, t = len(s.text_ids), s.mel.shape[0]
            texts[i, :c] = s.text_ids
            durations[i, :c] = s.duration[:c]
            if energies is not None and s.energy is not None:
                energies[i, :c] = s.energy[:c]
            if kurtoses is not None and s.kurtosis is not None:
                kurtoses[i, :c] = s.kurtosis[:c]
            mels[i, :t] = s.mel[:max_t]
            if cells is not None:
                cells[i, :c] = s.cells
            src_lens[i] = c
            audiotypes[i] = s.audiotype_id
            names.append(s.basename)
        batch = {
            "audiotypes": audiotypes,
            "texts": texts,
            "src_lens": src_lens,
            "mels": mels,
            "mel_lens": mel_lens,
            "durations": durations,
            "names": names,
        }
        if energies is not None:
            batch["energies"] = energies
        if kurtoses is not None:
            batch["kurtoses"] = kurtoses
        if cells is not None:
            batch["image_cells"] = cells.astype(np.float32) / 255.0
        return batch

    def _row_text_len(self, i: int) -> int:
        """Metadata text length of row i == len(encode_text(text)): the ONE
        place the cleaned-length rule lives — batch_plan's sort key and
        plan_pad_shapes' pad targets must agree with what collate derives
        from the loaded samples (multi-host shape agreement rests on it)."""
        t = self.rows[i][4]
        return len(t.replace("{", "").replace("}", ""))

    def batch_plan(self, group_size: int = 4, seed: int | None = None,
                   shuffle: bool = True) -> list[list[int]]:
        """The epoch's exact batch composition as row-index lists, computed
        from METADATA ONLY (no feature files touched).

        Pools group_size*batch_size rows, sorts the pool by text length
        (when self.sort) and slices into batches — the reference's
        collate_fn strategy, which minimizes padding waste per batch. The
        sort key is the encoded text length, which equals the cleaned
        metadata text length (symbols.encode_text is one id per char), so
        the plan is exact without loading a single sample — this is what
        lets worker processes load batches independently (data/loader.py).
        """
        order = np.arange(len(self.rows))
        if shuffle:
            rng = np.random.default_rng(
                seed if seed is not None else self.config.train.seed)
            rng.shuffle(order)

        plan: list[list[int]] = []
        pool_size = group_size * self.batch_size
        for start in range(0, len(order), pool_size):
            pool_idx = [int(i) for i in order[start : start + pool_size]]
            if self.sort:
                pool_idx.sort(key=lambda i: -self._row_text_len(i))  # stable, like
                # the Sample-object sort it replaces
            for b in range(0, len(pool_idx), self.batch_size):
                chunk = pool_idx[b : b + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                plan.append(chunk)
        return plan

    def load_batch(self, idx_list: list[int],
                   pad_to: tuple[int, int] | None = None) -> dict:
        """Load + collate one planned batch (the per-batch worker unit)."""
        return self.collate([self[i] for i in idx_list], pad_to=pad_to)

    # ------------------------------------------------------------------
    def mel_len_index(self) -> np.ndarray:
        """Per-row mel length (frames), aligned with self.rows.

        Duration files already pin sum(durations) == mel frames (pinned by
        tests/test_pipeline_e2e.py), so one pass over the tiny duration
        .npy files yields every batch's pad target without touching a mel.
        Cached in memory; ~seconds for the full RWCP corpus."""
        if getattr(self, "_mel_lens", None) is None:
            out = np.empty(len(self.rows), np.int32)
            for i, (name, audiotype, *_rest) in enumerate(self.rows):
                d = np.load(self.root / "duration" / audiotype / f"{name}.npy")
                out[i] = int(d.sum())
            self._mel_lens = out
        return self._mel_lens

    def plan_pad_shapes(self, plan: list[list[int]]) -> list[tuple[int, int]]:
        """(max_c, max_t) pad targets for each planned batch, METADATA ONLY
        (text lengths from the rows, mel lengths from mel_len_index).

        Exactly reproduces what `collate` would derive from the loaded
        samples — which is what lets each host of a multi-process run load
        only its own row slice and still agree on batch shapes
        (data/loader.py local_slice; parallel/distributed.py)."""
        mel_lens = self.mel_len_index()

        shapes = []
        for chunk in plan:
            max_c = _round_up(max(self._row_text_len(i) for i in chunk),
                              self.text_bucket)
            max_t = min(_round_up(int(max(mel_lens[i] for i in chunk)),
                                  self.mel_bucket),
                        self.config.train.max_mel_len)
            shapes.append((max_c, max_t))
        return shapes

    def batches(self, group_size: int = 4, seed: int | None = None,
                shuffle: bool = True):
        """Yield static-shaped batch dicts (serial; see data/loader.py for
        the process-parallel epoch iterator)."""
        for chunk in self.batch_plan(group_size, seed, shuffle):
            yield self.load_batch(chunk)


# host-only keys of a batch (names; mel_lens, which the model recomputes)
HOST_KEYS = ("names", "mel_lens")


def to_device(batch: dict, device) -> dict:
    """The model inputs and targets of a numpy batch as tensors on `device`."""
    import torch

    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items() if k not in HOST_KEYS}
