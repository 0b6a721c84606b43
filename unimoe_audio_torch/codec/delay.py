"""Channel delay-pattern ops for the RVQ codec token layout — a numpy copy
of `unimoe_audio_tpu/codec/delay.py`.

  apply:   out[b, t, c] = BOS            if t <  delay[c]
                        = audio[b, t - delay[c], c]   otherwise
  revert:  out[b, t, c] = PAD            if t + delay[c] >= T
                        = audio[b, t + delay[c], c]   otherwise
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _shifted(audio: np.ndarray, shift: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    B, T, C = audio.shape
    t_idx = np.arange(T, dtype=np.int64)[None, :, None] + shift[None, None, :]   # [1, T, C]
    idx = np.broadcast_to(np.clip(t_idx, 0, T - 1), (B, T, C))
    return np.take_along_axis(audio, idx, axis=1), t_idx


def apply_audio_delay(audio_BxTxC: np.ndarray, pad_value: int, bos_value: int,
                      delay_pattern: Sequence[int]) -> np.ndarray:
    """Shift channel c later by delay[c] frames, BOS-filling the head."""
    audio = np.asarray(audio_BxTxC)
    T = audio.shape[1]
    gathered, t_idx = _shifted(audio, -np.asarray(delay_pattern, np.int64))
    out = np.where(t_idx < 0, bos_value, np.where(t_idx >= T, pad_value, gathered))
    return out.astype(audio.dtype)


def revert_audio_delay(audio_BxTxC: np.ndarray, pad_value: int,
                       delay_pattern: Sequence[int]) -> np.ndarray:
    """Undo apply_audio_delay; positions whose source is past the end are PAD."""
    audio = np.asarray(audio_BxTxC)
    T = audio.shape[1]
    gathered, t_idx = _shifted(audio, np.asarray(delay_pattern, np.int64))
    return np.where(t_idx >= T, pad_value, gathered).astype(audio.dtype)


def prepare_audio_prompt(audio_prompts: List[Optional[np.ndarray]], *, num_channels: int,
                         bos_value: int, delay_pattern: Sequence[int]
                         ) -> Tuple[np.ndarray, List[int]]:
    """Delayed prefill buffer [B, max_len, C] int32 (-1 = to be generated;
    row 0 = BOS, then each sample's prompt codes) and per-sample prefill
    step counts."""
    max_delay = max(delay_pattern)
    batch_size = len(audio_prompts)
    max_len = max((0 if p is None else int(p.shape[0])) for p in audio_prompts) + max_delay + 1
    prefill = np.full((batch_size, max_len, num_channels), -1, dtype=np.int32)
    prefill[:, 0, :] = bos_value
    prefill_steps: List[int] = []
    for i, prompt in enumerate(audio_prompts):
        if prompt is not None:
            prompt = np.asarray(prompt, dtype=np.int32)
            prefill[i, 1:prompt.shape[0] + 1, :] = prompt
            prefill_steps.append(int(prompt.shape[0]) + 1)
        else:
            prefill_steps.append(1)
    delayed = apply_audio_delay(prefill, pad_value=-1, bos_value=bos_value,
                                delay_pattern=delay_pattern)
    return delayed, prefill_steps


def generate_output(generated_codes: np.ndarray, lengths_Bx: np.ndarray, *, pad_value: int,
                    delay_pattern: Sequence[int]) -> List[np.ndarray]:
    """Undo the delay on generated codes; per-sample [T_i, C] arrays."""
    max_delay = max(delay_pattern)
    codebook = revert_audio_delay(np.asarray(generated_codes), pad_value=pad_value,
                                  delay_pattern=delay_pattern)
    codebook = codebook[:, :codebook.shape[1] - max_delay, :]
    lengths = np.asarray(lengths_Bx)
    return [codebook[i, :int(lengths[i]), :] for i in range(codebook.shape[0])]


def preprocess_codec(codec: np.ndarray, *, delay_pattern: Sequence[int], num_channels: int,
                     bos_value: int, eos_value: int, pad_value: int) -> np.ndarray:
    """Reference-audio codes with per-channel BOS run-in, one EOS, then PAD."""
    codec = np.asarray(codec, dtype=np.int64)
    token_len = codec.shape[0]
    max_delay = max(delay_pattern)
    out = np.zeros((token_len + max_delay + 1, num_channels), dtype=np.int64)
    for c in range(num_channels):
        start = delay_pattern[c] + 1
        out[:start, c] = bos_value
        out[start:start + token_len, c] = codec[:, c]
        out[start + token_len:, c] = pad_value
        if start + token_len < out.shape[0]:
            out[start + token_len, c] = eos_value
    return out
