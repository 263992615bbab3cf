"""WAV reading, writing and resampling (copy of visual_onoma_to_wave_tpu/data/audio_io.py).

`load_audio` reads a wav (PCM through the stdlib, IEEE float through a
minimal RIFF parser), mixes it to mono and resamples it with a polyphase
FIR (scipy's resample_poly, imported where used). `wav_bytes` is the one
float -> 16-bit PCM encoder, shared by `write_wav` and the HTTP server.
"""
from __future__ import annotations

import io
import pathlib
import struct
import wave
from fractions import Fraction

import numpy as np


def read_wav(path: str | pathlib.Path) -> tuple[np.ndarray, int]:
    """A wav -> (float32 mono in [-1, 1], sample rate)."""
    try:
        with wave.open(str(path), "rb") as w:
            sr, n, ch, width = w.getframerate(), w.getnframes(), w.getnchannels(), w.getsampwidth()
            raw = w.readframes(n)
    except wave.Error:
        return _read_wav_riff(path)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def _read_wav_riff(path: str | pathlib.Path) -> tuple[np.ndarray, int]:
    """The formats the stdlib `wave` rejects: IEEE float (tag 3) and
    WAVE_FORMAT_EXTENSIBLE (0xFFFE) wrapping PCM or float."""
    data = pathlib.Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos, fmt, payload = 12, None, None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = body
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    if fmt is None or payload is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    tag, ch, sr, _br, _ba, bits = struct.unpack("<HHIIHH", fmt[:16])
    if tag == 0xFFFE and len(fmt) >= 26:  # extensible: the real tag is in the GUID
        tag = struct.unpack("<H", fmt[24:26])[0]
    if tag == 3:
        x = np.frombuffer(payload, "<f4" if bits == 32 else "<f8").astype(np.float32)
    elif tag == 1:
        if bits == 16:
            x = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(payload, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(payload, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported wav format tag {tag}")
    if ch > 1:
        x = x[: (len(x) // ch) * ch].reshape(-1, ch).mean(axis=1)
    return x, sr


def wav_bytes(audio: np.ndarray, sample_rate: int) -> bytes:
    """float [-1, 1] mono audio -> the bytes of a 16-bit PCM wav file."""
    audio = np.clip(np.asarray(audio, dtype=np.float64), -1.0, 1.0)
    pcm = np.round(audio * 32767.0).astype("<i2")
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
    return buf.getvalue()


def write_wav(path: str | pathlib.Path, audio: np.ndarray, sample_rate: int) -> None:
    """Write float [-1, 1] mono audio as a 16-bit PCM wav."""
    pathlib.Path(path).write_bytes(wav_bytes(audio, sample_rate))


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (48000 -> 22050 is up 147, down 320)."""
    if orig_sr == target_sr:
        return audio.astype(np.float32)
    from scipy.signal import resample_poly

    frac = Fraction(target_sr, orig_sr)
    return resample_poly(audio.astype(np.float64), frac.numerator,
                         frac.denominator).astype(np.float32)


def load_audio(path: str | pathlib.Path, target_sr: int = 22050) -> np.ndarray:
    """Read a wav, mix it to mono and resample it to target_sr."""
    x, sr = read_wav(path)
    return resample(x, sr, target_sr)
