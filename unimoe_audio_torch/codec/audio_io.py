"""Waveform I/O with the standard library's `wave`, numpy and the host
library (`codec/native.py`, scipy without it) — counterpart of
`unimoe_audio_tpu/codec/audio_io.py`: read 8/16/24/32-bit PCM WAV, mono
mixdown, polyphase resampling, and 16-bit PCM output."""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np

from . import native


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file → (float32 [channels, T] in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n_ch = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width == 2:
        data = native.pcm16_to_f32(np.frombuffer(raw, dtype="<i2"))
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.int32)
        ints = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"Unsupported WAV sample width: {width}")
    return data.reshape(-1, n_ch).T, sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write float [T] or [channels, T] as 16-bit PCM WAV."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    pcm = native.f32_to_pcm16(audio)
    with wave.open(path, "wb") as f:
        f.setnchannels(pcm.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.T.tobytes())


def resample(audio: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    """Polyphase resampling: 1-D inputs and up to 8 channels channel by
    channel through `native.resample`, wider inputs through scipy."""
    audio = np.asarray(audio, dtype=np.float32)
    if sr_from == sr_to:
        return audio
    if audio.ndim == 1:
        return native.resample(audio, sr_from, sr_to)
    if audio.ndim == 2 and audio.shape[0] <= 8:
        return np.stack([native.resample(ch, sr_from, sr_to) for ch in audio])
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_from, sr_to)
    return resample_poly(audio, sr_to // g, sr_from // g, axis=-1).astype(np.float32)


def to_mono(audio: np.ndarray) -> np.ndarray:
    """[channels, T] → [1, T] by channel average."""
    if audio.shape[0] == 1:
        return audio
    return np.mean(audio, axis=0, keepdims=True).astype(np.float32)
