"""The comparison that decides `correct`: what the timed path returned for
the sampled requests, against the plain reference on the same inputs.

A record is one request as the program answered it: {"req", "C" (the padded
text length it was served at), "image", "durations", "energy", "mel_len",
"mel", "wav"}.

The reference renders the request, runs the acoustic model's encoder half
at the padded text length C, and checks each duration the program returned
against its own rounding of exp(log d) - 1 (a duration within
`DURATION_AMBIGUITY` frames of a rounding edge may go either way). It then
decodes with the program's durations, and with its own energy buckets but
where its energy lies within `ENERGY_AMBIGUITY` of a bucket edge, where it
takes the program's bucket, and vocodes. The reference reads the program's
outputs only to pick among these branches and to judge them.

Numbers (each with its limit from the configuration file):
  image_px_off   rendered pixels that differ (exact: limit 0)
  durations_off  durations that no rounding of the reference's gives, and
                 mel lengths other than min(sum of durations, max) (limit 0)
  energy_gap     largest |energy - reference's| over the characters
  mel_gap        worst request's RMS(mel - reference's) / RMS(reference's)
  wav_gap        worst request's RMS(wav - reference's) / RMS(reference's)
"""
from __future__ import annotations

import math

import numpy as np
import torch

MISSING = 1e9                  # the gap of an answer that is missing or misshapen
DURATION_AMBIGUITY = 1e-3      # frames from a rounding edge of exp(log d) - 1
ENERGY_AMBIGUITY = 1e-4        # normalised energy from a bucket edge
BLOCK = 8                      # rows the reference computes at once


def allowed_durations(raw: float, d_control: float) -> set[int]:
    """What the duration rounding of `raw` = exp(log d) - 1 gives, both ways
    where raw lies within DURATION_AMBIGUITY of a rounding edge."""
    base = math.floor(raw)
    rounds = {int(np.round(np.float32(raw)))}
    if abs(raw - (base + 0.5)) < DURATION_AMBIGUITY:
        rounds |= {base, base + 1}
    out = set()
    for r in rounds:
        out.add(int(max(float(np.float32(r) * np.float32(d_control)), 0.0)))
    return out


def rel_rms(got: np.ndarray, ref: np.ndarray) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return MISSING
    return float(np.sqrt(np.mean((got - ref) ** 2)) / max(np.sqrt(np.mean(ref ** 2)), 1e-30))


class Reference:
    """The configuration's reference families on `device`, over the weights."""

    def __init__(self, families: dict, cfg: dict, acoustic_w: dict, vocoder_w: dict, device,
                 q_acoustic=None, q_vocoder=None):
        self.f, self.cfg, self.device = families, cfg, device
        # float32 products in float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        ident = families["acoustic"].ident
        self.acoustic = families["acoustic"].Acoustic(acoustic_w, cfg["acoustic"],
                                                      cfg["metadata"], q_acoustic or ident)
        self.vw, self.qv = vocoder_w, q_vocoder or ident
        self.hop = cfg["acoustic"]["hop_length"]

    def render(self, req: dict) -> np.ndarray:
        return self.f["acoustic"].render(req["text"], req["width_rates"], self.cfg["acoustic"])

    def encode(self, reqs: list[dict], c: int) -> dict:
        """The encoder half for requests at padded text length c."""
        ac, md = self.cfg["acoustic"], self.cfg["metadata"]
        h, w = ac["cell_hw"]
        cells = np.ones((len(reqs), c, h, w), np.float32)
        for i, r in enumerate(reqs):
            n = len(r["text"])
            cells[i, :n] = self.f["acoustic"].cells_of(self.render(r), n, w)
        dev = self.device
        col = lambda key: torch.tensor([r[key] for r in reqs], dtype=torch.float32, device=dev)  # noqa: E731
        return self.acoustic.encode(
            torch.from_numpy(cells).to(dev),
            torch.tensor([md["audiotypes"].index(r["audiotype"]) for r in reqs], device=dev),
            torch.tensor([len(r["text"]) for r in reqs], device=dev),
            col("e_control"), col("d_control"))

    def decode_and_vocode(self, x, bucket, durations, mel_lens) -> tuple[list, list]:
        """Postnet mels (own frames) and waveforms (own samples) per row."""
        out = self.acoustic.decode(x, bucket, durations)
        mel = out["postnet_mel"]
        crop = min(mel.shape[1], int(max(mel_lens)) + self.cfg["vocoder"]["halo_frames"])
        wav = self.f["vocoder"].generate(self.vw, self.cfg["vocoder"], mel[:, :crop], self.qv)
        mels = [mel[i, :m].cpu().numpy() for i, m in enumerate(mel_lens)]
        wavs = [wav[i, :m * self.hop].cpu().numpy() for i, m in enumerate(mel_lens)]
        return mels, wavs


def judge(ref: Reference, records: list[dict]) -> dict:
    """The numbers over all records (see the module docstring)."""
    nums = {"image_px_off": 0, "durations_off": 0, "energy_gap": 0.0, "mel_gap": 0.0,
            "wav_gap": 0.0}
    by_c: dict[int, list[dict]] = {}
    for r in records:
        nums["image_px_off"] += int(np.count_nonzero(ref.render(r["req"]) != r["image"]))
        by_c.setdefault(r["C"], []).append(r)
    for c, recs in sorted(by_c.items()):
        for b0 in range(0, len(recs), BLOCK):
            block = recs[b0:b0 + BLOCK]
            _judge_block(ref, ref.encode([r["req"] for r in block], c), block, c, nums)
    return nums


def _judge_block(ref, enc, recs, c, nums) -> None:
    t_max = ref.cfg["acoustic"]["max_mel_len"]
    raw = enc["raw"].cpu().numpy()
    energy = enc["energy"].cpu().numpy()
    bucket = enc["bucket"].clone()
    bins = ref.acoustic.bins.cpu().numpy()
    durations = torch.zeros((len(recs), c), dtype=torch.int32)
    bad = []
    for row, r in enumerate(recs):
        req, n = r["req"], len(r["req"]["text"])
        d = np.asarray(r["durations"], np.int64)
        off = 0 if len(d) == n else n
        for j in range(min(n, len(d))):
            off += int(d[j]) not in allowed_durations(float(raw[row, j]), req["d_control"])
        want = max(1, min(int(d[:n].sum()), t_max)) if len(d) == n else -1
        off += int(r["mel_len"] != want)
        bad.append(off)
        durations[row, :len(d[:n])] = torch.from_numpy(d[:n].astype(np.int32))
        e = np.asarray(r["energy"], np.float32)
        nums["energy_gap"] = max(nums["energy_gap"],
                                 float(np.max(np.abs(e[:n] - energy[row, :n]))) if
                                 len(e) == n else MISSING)
        if len(e) == n:
            for j in range(n):
                if np.min(np.abs(bins - energy[row, j])) < ENERGY_AMBIGUITY:
                    bucket[row, j] = int(np.searchsorted(bins, e[j], side="left"))
    nums["durations_off"] += sum(bad)
    mel_lens = [max(1, min(int(durations[row].sum()), t_max)) for row in range(len(recs))]
    mels, wavs = ref.decode_and_vocode(enc["x"], bucket, durations.to(ref.device), mel_lens)
    for row, r in enumerate(recs):
        wav_gap, mel_gap = rel_rms(r["wav"], wavs[row]), rel_rms(r["mel"], mels[row])
        if bad[row]:
            wav_gap = mel_gap = MISSING
        nums["wav_gap"] = max(nums["wav_gap"], wav_gap)
        nums["mel_gap"] = max(nums["mel_gap"], mel_gap)
