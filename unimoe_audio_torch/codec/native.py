"""ctypes bindings to the repo's host library `native/hostlib.cpp` —
counterpart of `unimoe_audio_tpu/codec/native.py`: PCM conversion,
resampling, a mono mixdown and the right-padded collation of token
sequences.

The library is built on first use with the same g++ command as the JAX
package's (so both packages run the same machine code on one machine), but
into the port's git-ignored `unimoe_audio_torch/_build/`, never beside the
source.  Every entry point keeps the JAX package's numpy / scipy fallback
for a machine without g++; `available()` says which path this process
takes.  Host code only: nothing here touches the GPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "hostlib.cpp")
LIBRARY = os.path.join(_PKG, "_build", "hostlib.so")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build() -> None:
    """g++ into a temporary file beside LIBRARY, then an atomic rename, so
    that processes building at once never load a half-written library."""
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(LIBRARY))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, SOURCE],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        if not os.path.isfile(LIBRARY) or os.path.getmtime(LIBRARY) < os.path.getmtime(SOURCE):
            _build()
        lib = ctypes.CDLL(LIBRARY)
        lib.pcm16_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.f32_to_pcm16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.resample_poly.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                      ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_int32]
        lib.resample_poly.restype = ctypes.c_int64
        lib.mixdown.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                ctypes.c_int32]
        lib.collate_pad_i64.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                                        ctypes.c_int64, ctypes.c_void_p]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    """True when the host library is built and loaded (the native path)."""
    return _build_and_load() is not None


def pcm16_to_f32(pcm: np.ndarray) -> np.ndarray:
    lib = _build_and_load()
    pcm = np.ascontiguousarray(pcm, dtype="<i2")
    if lib is None:
        return pcm.astype(np.float32) / 32768.0
    out = np.empty(pcm.shape, dtype=np.float32)
    lib.pcm16_to_f32(pcm.ctypes.data, out.ctypes.data, pcm.size)
    return out


def f32_to_pcm16(audio: np.ndarray) -> np.ndarray:
    lib = _build_and_load()
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    if lib is None:
        return (np.clip(audio, -1.0, 1.0) * 32767.0).round().astype("<i2")
    out = np.empty(audio.shape, dtype="<i2")
    lib.f32_to_pcm16(audio.ctypes.data, out.ctypes.data, audio.size)
    return out


def resample(audio: np.ndarray, sr_from: int, sr_to: int, taps: int = 32) -> np.ndarray:
    """1-D polyphase resample (hostlib's 32-tap windowed sinc); scipy's
    `resample_poly` without the library."""
    if sr_from == sr_to:
        return np.asarray(audio, dtype=np.float32)
    from math import gcd

    g = gcd(sr_from, sr_to)
    up, down = sr_to // g, sr_from // g
    lib = _build_and_load()
    x = np.ascontiguousarray(audio, dtype=np.float32)
    if lib is None or x.ndim != 1:
        from scipy.signal import resample_poly

        return resample_poly(x, up, down, axis=-1).astype(np.float32)
    cap = (x.shape[0] * up + down - 1) // down
    out = np.empty(cap, dtype=np.float32)
    n = lib.resample_poly(x.ctypes.data, x.shape[0], out.ctypes.data, cap, up, down, taps)
    return out[:n]


def mixdown(interleaved: np.ndarray) -> np.ndarray:
    """[T, C] float32 → [T] mono average (`native.py:79-87`); numpy's mean
    without the library or for another rank."""
    lib = _build_and_load()
    x = np.ascontiguousarray(interleaved, dtype=np.float32)
    if lib is None or x.ndim != 2:
        return x.mean(axis=-1)
    out = np.empty(x.shape[0], dtype=np.float32)
    lib.mixdown(x.ctypes.data, out.ctypes.data, x.shape[0], x.shape[1])
    return out


def collate_pad(seqs, pad_value: int, max_len: Optional[int] = None) -> np.ndarray:
    """1-D int sequences → [n, max_len] int64, right-padded with pad_value
    and cut at max_len (default: the longest) (`native.py:109-127`)."""
    lengths = np.asarray([len(s) for s in seqs], dtype=np.int64)
    T = int(lengths.max()) if max_len is None else max_len
    out = np.full((len(seqs), T), pad_value, dtype=np.int64)
    lib = _build_and_load()
    if lib is None:
        for i, s in enumerate(seqs):
            n = min(len(s), T)
            out[i, :n] = np.asarray(s[:n], dtype=np.int64)
        return out
    flat = np.ascontiguousarray(np.concatenate([np.asarray(s, dtype=np.int64) for s in seqs])
                                if len(seqs) else np.zeros(0, np.int64))
    lib.collate_pad_i64(flat.ctypes.data, lengths.ctypes.data, len(seqs), T, out.ctypes.data)
    return out
