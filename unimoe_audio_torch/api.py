"""UniMoEAudio — the user-facing text-to-music API of the port.

Counterpart of `unimoe_audio_tpu/api.py` for the bf16, dense-dispatch
configuration (`serving_mode=False`): the same prompt template, 64-token
left-padded buckets, CFG pairs and generation defaults.  Runs on CUDA
unless the caller passes `device="cpu"`; without a GPU it raises rather
than running on the CPU.  The quantized serving modes, TTS and VT2M come
with later slices.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Union

import numpy as np
import torch

from .codec import delay as dl
from .codec.dac import tiny_dac_config
from .codec.dac_wrapper import Dac
from .config import UniMoEAudioConfig, tiny_test_config
from .generate.loop import generate, generate_chunked, pad_buffer
from .models.model import init_model_params
from .tokenizer import SimpleTokenizer

# Prompt templates (as in the JAX package's api.py).
SYSTEM_MESSAGE = "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n"
INPUT_FORMAT = "<|im_start|>user\n{}<|im_end|>\n<|im_start|>assistant\n"
AUDIO_START = "<|AUDIO_START|>"

SPECIAL_TOKENS = [
    "<|AUDIO_PLACEHOLDER|>", "<|AUDIO_START|>", "<|AUDIO_END|>",
    "<|SPEECH_START|>", "<|SPEECH_END|>",
    "<|VOICE_PROMPT_START|>", "<|VOICE_PROMPT_END|>",
    "<|SPEECH_PROMPT_START|>", "<|SPEECH_PROMPT_END|>",
    "<|MUSIC_START|>", "<|MUSIC_END|>",
]

T2M_NEGATIVE_CAPTION = "Low quality."


def music_span(caption: str) -> str:
    return "<|MUSIC_START|>" + caption + "<|MUSIC_END|>"


def t2m_prompt(caption: str) -> str:
    """The T2M prompt layout."""
    return SYSTEM_MESSAGE + INPUT_FORMAT.format(music_span(caption)) + AUDIO_START


def _bucket(n: int, step: int = 64) -> int:
    return max(step, ((n + step - 1) // step) * step)


def resolve_device(device=None) -> torch.device:
    """`device`, defaulting to CUDA; raises when CUDA is asked for (or
    defaulted to) and no GPU is present — the port never falls back to the
    CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def set_matmul_precision() -> None:
    """Full f32 precision for f32 matmuls and convolutions.  The DAC runs
    in f32 through cuDNN, which would use TF32 by default (about three
    decimal digits); the port keeps full f32 there, as the reference does.
    The model's bf16 matmuls are unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class UniMoEAudio:
    """Text-to-music generation (bf16, dense dispatch)."""

    MAX_TOKENS = 1000   # ≤ 20 s of audio at 50 frames/s
    MIN_TOKENS = 100

    def __init__(
        self,
        model_path: Optional[str] = None,
        *,
        allow_random: bool = False,
        config: Optional[UniMoEAudioConfig] = None,
        dtype: torch.dtype = torch.bfloat16,
        device=None,
        max_tokens: Optional[int] = None,
        min_tokens: Optional[int] = None,
        serving_mode=False,
    ):
        """allow_random: random weights from a fixed seed for `config`
        (default the tiny test config), a random 16 kHz DAC (the tiny DAC
        for configs with other than 12 codec channels) and the development
        tokenizer.  Loading checkpoints (model_path) and the quantized
        serving modes (serving_mode other than False) come with later
        slices."""
        if model_path is not None:
            raise NotImplementedError(
                "loading checkpoints comes with the checkpoint-conversion slice; "
                "pass allow_random=True")
        if not allow_random:
            raise ValueError("allow_random=True is required until checkpoints can be loaded")
        if serving_mode is not False:
            raise NotImplementedError(
                f"serving_mode={serving_mode!r} (quantized serving) comes with the "
                "quantization slice; this port serves bf16 with serving_mode=False")
        self.device = resolve_device(device)
        set_matmul_precision()
        self.MAX_TOKENS = max_tokens if max_tokens is not None else UniMoEAudio.MAX_TOKENS
        self.MIN_TOKENS = min_tokens if min_tokens is not None else UniMoEAudio.MIN_TOKENS
        self.config = config or tiny_test_config()
        self.params = init_model_params(self.config, seed=0, dtype=dtype, device=self.device)
        special = {t: 100 + i for i, t in enumerate(SPECIAL_TOKENS)}
        special["<|AUDIO_PLACEHOLDER|>"] = self.config.codec_placeholder_value
        special["<|vision_start|>"] = self.config.vision_start_token_id
        special["<|vision_end|>"] = self.config.vision_end_token_id
        special["<|video_pad|>"] = self.config.video_token_id
        self.tokenizer = SimpleTokenizer(
            vocab_size=min(self.config.text_config.vocab_size, 10000), special=special)
        dac_cfg = None
        if self.config.codec_channels != 12:
            dac_cfg = dataclasses.replace(tiny_dac_config(),
                                          n_codebooks=self.config.codec_channels)
        self.dac = Dac(allow_random=True, config=dac_cfg, device=self.device)
        self.last_timings: dict = {}
        self.last_codes: List[np.ndarray] = []

    def _tokenize(self, texts: List[str]):
        out = self.tokenizer(texts, add_special_tokens=False, padding=True, return_tensors="np")
        ids = np.asarray(out["input_ids"], dtype=np.int32)
        mask = np.asarray(out["attention_mask"], dtype=np.int32)
        # Bucket the text length, padding on the LEFT.
        T = _bucket(ids.shape[1])
        if T > ids.shape[1]:
            pad = np.full((ids.shape[0], T - ids.shape[1]), self.tokenizer.pad_token_id,
                          dtype=np.int32)
            ids = np.concatenate([pad, ids], axis=1)
            mask = np.concatenate([np.zeros_like(pad), mask], axis=1)
        return ids, mask

    @torch.inference_mode()
    def _generate_core(
        self,
        input_ids: np.ndarray,
        attention_mask: np.ndarray,
        save_name: str,
        output_dir: str = "./",
        cfg_scale: float = 0.0,
        temperature: float = 1.0,
        top_p: float = 1.0,
        cfg_filter_top_k: int = 45,
        eos_prob_mul_factor: float = 0.6,
        do_sample: bool = True,
        seed: Optional[int] = None,
        max_tokens: Optional[int] = None,
        min_tokens=None,
    ) -> List[str]:
        """Generate codes for CFG-interleaved rows, decode them to wavs
        (`api.py:398-569`).  Keeps the per-stream codes [T_i, C] in
        `self.last_codes` and fills `self.last_timings` with the device-
        synchronised seconds of the prefill, the decode and the DAC."""
        cfg = self.config
        max_tokens = max_tokens if max_tokens is not None else self.MAX_TOKENS
        min_tokens = min_tokens if min_tokens is not None else self.MIN_TOKENS
        batch_size = input_ids.shape[0] // 2
        prefill, prefill_steps = dl.prepare_audio_prompt(
            [None] * batch_size, num_channels=cfg.codec_channels,
            bos_value=cfg.codec_bos_value, delay_pattern=cfg.codec_delay_pattern)
        buf = pad_buffer(torch.as_tensor(prefill, device=self.device), max_tokens)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed if seed is not None else int(time.time() * 1e3) % (2 ** 31))
        # Long generations grow the KV cache chunk by chunk.
        gen_fn = generate_chunked if max_tokens >= 512 else generate
        timings: dict = {}
        res = gen_fn(
            self.params, cfg,
            torch.as_tensor(input_ids, device=self.device),
            torch.as_tensor(attention_mask, device=self.device),
            None, buf, prefill_steps, gen,
            max_tokens=max_tokens, min_tokens=min_tokens, cfg_scale=cfg_scale,
            temperature=temperature, top_p=top_p, cfg_filter_top_k=cfg_filter_top_k,
            eos_prob_mul_factor=eos_prob_mul_factor, do_sample=do_sample, timings=timings,
        )
        codes = res.codes.cpu().numpy()
        lengths = res.lengths.cpu().numpy()
        timings.update(steps=res.steps, lengths=lengths.tolist())
        audios = dl.generate_output(codes, lengths, pad_value=cfg.codec_pad_value,
                                    delay_pattern=cfg.codec_delay_pattern)

        os.makedirs(output_dir, exist_ok=True)
        output_paths = [os.path.join(output_dir, f"generated_{save_name}_{i}.wav")
                        for i in range(len(audios))]
        t0 = time.perf_counter()
        self.dac.decode_batch([frames.T for frames in audios], output_paths, min_duration=1)
        timings["dac_s"] = time.perf_counter() - t0
        self.last_timings = timings
        self.last_codes = audios
        return output_paths

    def text_to_music(
        self,
        caption: Union[str, List[str]],
        save_name: str = "music",
        output_dir: str = "./",
        cfg_scale: float = 10.0,
        temperature: float = 1.0,
        top_p: float = 1.0,
        cfg_filter_top_k: int = 45,
        eos_prob_mul_factor: float = 0.6,
        do_sample: bool = True,
        seed: Optional[int] = None,
        max_audio_seconds: Optional[float] = None,
        min_audio_seconds: Optional[float] = None,
    ) -> List[str]:
        """Text-to-music (`api.py:574-617`): one wav per caption.
        max/min_audio_seconds count 50 frames per second."""
        mt = int(max_audio_seconds * 50) if max_audio_seconds is not None else None
        mn = int(min_audio_seconds * 50) if min_audio_seconds is not None else None
        caption = [caption] if isinstance(caption, str) else [c for c in caption if c.strip()]
        if not caption or not all(c.strip() for c in caption):
            print("Please enter a music description.")
            return []
        neg = t2m_prompt(T2M_NEGATIVE_CAPTION)
        text_input = []
        for c in caption:
            text_input.append(neg)
            text_input.append(t2m_prompt(c))
        ids, mask = self._tokenize(text_input)
        t0 = time.time()
        paths = self._generate_core(
            ids, mask, save_name, output_dir, cfg_scale, temperature, top_p,
            cfg_filter_top_k, eos_prob_mul_factor, do_sample, seed,
            max_tokens=mt, min_tokens=mn)
        print(f"Music generation completed! Time: {time.time() - t0:.2f}s")
        return paths
