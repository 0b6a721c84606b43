"""High-level Dac with the reference's surface — counterpart of
`unimoe_audio_tpu/codec/dac_wrapper.py`:

  encode(audio_path) → python list [T][n_codebooks] of codes
  decode(codes [1, n_codebooks, T], save_path, min_duration) → a 16-bit wav

Weights are a converted pickle of the JAX layout (`core/convert.py`
`convert_dac_weights`, numpy leaves, read with numpy alone), found as the
JAX package finds them: an explicit path, else the DAC_WEIGHTS variable,
else `dac_model/weights_16khz.jax.pkl` beside this module or in the working
directory.  Without weights: random ones from a seed when allow_random,
else FileNotFoundError.  Runs on CUDA unless device="cpu"."""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np
import torch

from . import audio_io
from .dac import DACConfig, dac_decode, dac_encode, init_dac_params


class Dac:
    def __init__(self, weights_path: Optional[str] = None, *, allow_random: bool = False,
                 config: Optional[DACConfig] = None, device=None):
        from ..api import resolve_device
        from ..core.bridge import dac_params_from_jax

        self.config = config or DACConfig()
        self.device = resolve_device(device)
        path = self._resolve_weights(weights_path)
        if path is not None:
            with open(path, "rb") as f:
                blob = pickle.load(f)
            if "config" in blob:
                c = dict(blob["config"])
                c["encoder_rates"] = tuple(c["encoder_rates"])
                c["decoder_rates"] = tuple(c["decoder_rates"])
                self.config = DACConfig(**c)
            self.params = dac_params_from_jax(blob["params"], self.device, torch.float32)
        elif allow_random:
            self.params = init_dac_params(self.config, device=self.device)
        else:
            raise FileNotFoundError(
                "DAC weights not found. Set DAC_WEIGHTS to a converted weights file (see "
                "unimoe_audio_torch.core.convert.convert_dac_weights) or pass allow_random=True "
                "for random-weight operation.")

    @staticmethod
    def _resolve_weights(explicit: Optional[str]) -> Optional[str]:
        candidates = []
        if explicit:
            if not os.path.isfile(explicit):
                # A path named explicitly never falls through to other weights.
                raise FileNotFoundError(f"DAC weights not found: {explicit}")
            candidates.append(explicit)
        env = os.environ.get("DAC_WEIGHTS")
        if env:
            candidates.append(env)
        for root in (os.path.dirname(__file__), os.getcwd()):
            candidates.append(os.path.join(root, "dac_model", "weights_16khz.jax.pkl"))
        return next((p for p in candidates if p and os.path.isfile(p)), None)

    @torch.no_grad()
    def _encode(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        """[C, T] waveform at sample_rate → codes [T_frames, n_codebooks]."""
        audio = audio_io.resample(audio_io.to_mono(audio), sample_rate, self.config.sample_rate)
        x = torch.as_tensor(np.ascontiguousarray(audio[None]), device=self.device)  # [1, 1, T]
        codes = dac_encode(self.params, x, self.config)[0].T.cpu().numpy()
        assert codes.ndim == 2 and codes.shape[1] == self.config.n_codebooks
        return codes

    def encode_array(self, audio: np.ndarray, sample_rate: int) -> np.ndarray:
        """Raw waveform [T] or [C, T] → codes [T_frames, n_codebooks]."""
        audio = np.asarray(audio, dtype=np.float32)
        return self._encode(audio[None] if audio.ndim == 1 else audio, sample_rate)

    def encode(self, audio_path: str) -> List[List[int]]:
        """wav file → [T][n_codebooks] code list (the reference's layout)."""
        return self._encode(*audio_io.read_wav(audio_path)).tolist()

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
