"""Waveform output: 16-bit PCM WAV with the standard library's `wave`
and numpy (counterpart of `write_wav` in `unimoe_audio_tpu/codec/audio_io.py`,
using the numpy PCM conversion of `codec/native.py`; the native host
library comes with the apps slice)."""

from __future__ import annotations

import wave

import numpy as np


def f32_to_pcm16(audio: np.ndarray) -> np.ndarray:
    """Float in [-1, 1] → little-endian int16 (clipped, rounded)."""
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    return (np.clip(audio, -1.0, 1.0) * 32767.0).round().astype("<i2")


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """Write float [T] or [channels, T] as 16-bit PCM WAV."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    pcm = f32_to_pcm16(audio)
    with wave.open(path, "wb") as f:
        f.setnchannels(pcm.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.T.tobytes())
