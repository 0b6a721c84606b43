"""High-level Dac decoder with the reference's surface — counterpart of
`unimoe_audio_tpu/codec/dac_wrapper.py` (decode side; `encode` comes with
the TTS slice)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from . import audio_io
from .dac import DACConfig, dac_decode, init_dac_params


class Dac:
    def __init__(self, *, allow_random: bool = False, config: Optional[DACConfig] = None,
                 device="cuda"):
        """Random weights when allow_random, else FileNotFoundError: loading
        converted weights comes with the checkpoint slice."""
        if not allow_random:
            raise FileNotFoundError(
                "DAC weights are not loadable yet: pass allow_random=True for "
                "random-weight operation")
        self.config = config or DACConfig()
        self.device = torch.device(device)
        self.params = init_dac_params(self.config, device=self.device)

    @torch.no_grad()
    def _decode(self, codes: np.ndarray) -> np.ndarray:
        codes_t = torch.as_tensor(np.asarray(codes), dtype=torch.long, device=self.device)
        return dac_decode(self.params, codes_t, self.config).float().cpu().numpy()

    def decode_array(self, codes) -> np.ndarray:
        """codes [1, n_codebooks, T] → waveform [1, T·hop]."""
        return self._decode(codes)[0]

    def decode(self, codes, save_path: str, min_duration: Optional[float] = None) -> np.ndarray:
        """codes [1, n_codebooks, T] → writes a 16-bit wav, returns the waveform."""
        codes = np.asarray(codes)
        assert codes.shape[0] == 1 and codes.shape[1] == self.config.n_codebooks
        audio = self._decode(codes)[0]
        audio = self._pad_to(audio, min_duration)
        audio_io.write_wav(save_path, audio, self.config.sample_rate)
        return audio

    def _pad_to(self, audio: np.ndarray, min_duration: Optional[float]) -> np.ndarray:
        sr = self.config.sample_rate
        duration = audio.shape[-1] / sr
        if min_duration is not None and duration < min_duration:
            pad = int((min_duration - duration) * sr)
            audio = np.concatenate([audio, np.zeros((1, pad), audio.dtype)], axis=-1)
        return audio

    def decode_batch(self, codes_list, save_paths, min_duration=None) -> List[np.ndarray]:
        """One decoder forward for variable-length [C, T_i] code sequences
        (each padded to the batch max by repeating its last frame), sliced
        back to T_i · hop samples and written as wavs."""
        assert len(codes_list) == len(save_paths)
        lens = [np.asarray(c).shape[-1] for c in codes_list]
        T = max(lens)
        batch = np.zeros((len(codes_list), self.config.n_codebooks, T), np.int64)
        for i, c in enumerate(codes_list):
            c = np.asarray(c)
            batch[i, :, :lens[i]] = c
            if 0 < lens[i] < T:
                batch[i, :, lens[i]:] = c[:, -1:]
        audio = self._decode(batch)                                  # [B, 1, T·hop]
        hop = audio.shape[-1] // T
        assert audio.shape[-1] == T * hop, f"decoder output {audio.shape[-1]} not a multiple of T={T}"
        out = []
        for i, path in enumerate(save_paths):
            a = self._pad_to(audio[i, :, :lens[i] * hop], min_duration)
            audio_io.write_wav(path, a, self.config.sample_rate)
            out.append(a)
        return out
