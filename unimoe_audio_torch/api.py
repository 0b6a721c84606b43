"""UniMoEAudio — the user-facing text-to-music API of the port.

Counterpart of `unimoe_audio_tpu/api.py`: the same prompt template,
64-token left-padded buckets, CFG pairs and generation defaults, bf16 with
dense dispatch (`serving_mode=False`) or the quantized serving modes
(int8 / int4 / int4-gptq weights, a8 expert compute, the int8 KV cache,
capacity-packed dispatch) and their snapshots.  Runs on CUDA unless the
caller passes `device="cpu"`; without a GPU it raises rather than running
on the CPU.  TTS and VT2M come with later slices.
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
from .generate.loop import _sync, generate, generate_chunked, pad_buffer
from .models.model import init_model_params
from .tokenizer import SimpleTokenizer

SERVING_MODES = (False, True, "int8", "int4", "int4-gptq")

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


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


class UniMoEAudio:
    """Text-to-music generation."""

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
        gptq_calibration: Optional[dict] = None,
        kv_cache_dtype: Optional[str] = None,
        a8_compute: bool = True,
    ):
        """allow_random: random weights from a fixed seed for `config`
        (default the tiny test config), a random 16 kHz DAC (the tiny DAC
        for configs with other than 12 codec channels) and the development
        tokenizer; it is required, as the DAC's weights are always random
        until checkpoints can be loaded.  model_path: a directory holding a
        serving snapshot (`save_serving_snapshot`, or the JAX package's
        `serving.jax.pkl`), whose params load already quantized; loading
        checkpoints comes with a later slice.

        serving_mode (`api.py:94-191`): True or "int8" quantizes the
        attention projections, expert FFNs and output heads to per-channel
        int8, pads the expert FFNs to 128 columns and sizes packed dispatch
        from the batch; "int4" requantizes the experts to int4; "int4-gptq"
        quantizes them with GPTQ against a greedy self-calibration run
        (`gptq_calibration`: {"captions", "frames", "group_size"}) first.
        kv_cache_dtype="int8" keeps the KV cache in int8.  a8_compute runs
        the packed expert FFNs in int8 (`packed_a8`) where serving selects
        packed dispatch.  `load_timings` holds the seconds of each stage."""
        if serving_mode not in SERVING_MODES:
            raise ValueError(f"serving_mode must be one of {SERVING_MODES}, got {serving_mode!r}")
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None or 'int8', got {kv_cache_dtype!r}")
        from .core.export import find_serving_snapshot, load_serving_snapshot

        snapshot = model_path is not None and find_serving_snapshot(model_path) is not None
        if model_path is not None and not snapshot:
            raise NotImplementedError(
                f"{model_path} holds no serving snapshot; loading checkpoints comes with the "
                "checkpoint-conversion slice (pass allow_random=True without a model_path)")
        if not allow_random:
            raise ValueError("allow_random=True is required until checkpoints can be loaded")
        self.device = resolve_device(device)
        set_matmul_precision()
        self.MAX_TOKENS = max_tokens if max_tokens is not None else UniMoEAudio.MAX_TOKENS
        self.MIN_TOKENS = min_tokens if min_tokens is not None else UniMoEAudio.MIN_TOKENS
        self.load_timings: dict = {}
        t0 = time.perf_counter()
        if snapshot:
            self.config, self.params, snap_mode, snap_kv = load_serving_snapshot(
                model_path, self.device)
            if serving_mode not in (False, snap_mode):
                raise ValueError(f"the snapshot was quantized as {snap_mode!r}; pass "
                                 f"serving_mode={snap_mode!r} or leave it out")
            serving_mode = snap_mode
            kv_cache_dtype = kv_cache_dtype or snap_kv
        else:
            self.config = config or tiny_test_config()
            self.params = init_model_params(self.config, seed=0, dtype=dtype, device=self.device)
        _sync(self.device)
        self.load_timings["load_s"] = time.perf_counter() - t0
        self.serving_mode = serving_mode
        self.kv_cache_dtype = kv_cache_dtype
        self.a8_compute = a8_compute
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
        if serving_mode and not snapshot:
            self._quantize(serving_mode, gptq_calibration or {})

    def _quantize(self, serving_mode, gptq_calibration: dict) -> None:
        """The JAX constructor's pipeline (`api.py:172-191`): GPTQ experts
        first for "int4-gptq" (the int8 pass leaves QTensor leaves alone),
        int8 in place, the expert FFNs padded, then int4 for "int4"."""
        from .ops.quant import (pad_expert_ffn, quantize_model_params_inplace,
                                requantize_experts_int4_inplace)

        if serving_mode == "int4-gptq":
            self._gptq_quantize_experts(**gptq_calibration)
        t0 = time.perf_counter()
        quantize_model_params_inplace(self.params)
        pad_expert_ffn(self.params)
        if serving_mode == "int4":
            requantize_experts_int4_inplace(self.params)
        _sync(self.device)
        self.load_timings["quantize_s"] = time.perf_counter() - t0

    def save_serving_snapshot(self, out_dir: str) -> str:
        """The quantized serving params, config and modes into out_dir
        (`core/export.py`); a UniMoEAudio pointed at out_dir loads them and
        skips the quantization pass."""
        if not self.serving_mode:
            raise ValueError("snapshots hold quantized serving params; no serving_mode is set")
        from .core.export import save_serving_snapshot

        return save_serving_snapshot(self.params, self.config, out_dir,
                                     serving_mode=self.serving_mode,
                                     kv_cache_dtype=self.kv_cache_dtype)

    # GPTQ self-calibration captions (the JAX package's `api.py:325-335`).
    GPTQ_CALIB_CAPTIONS = [
        "Upbeat electronic dance track with a driving bassline.",
        "Gentle acoustic guitar ballad, warm and intimate.",
        "Orchestral film score with sweeping strings and brass.",
        "Lo-fi hip hop beat with vinyl crackle and mellow keys.",
        "Fast bebop jazz with a saxophone solo and walking bass.",
        "Ambient drone with slowly evolving synthesizer pads.",
        "Heavy metal riff with distorted guitars and double kick drums.",
        "Solo piano nocturne, melancholic and sparse.",
    ]

    @torch.inference_mode()
    def _calibration_batch(self, captions, frames: int):
        """The GPTQ calibration sequences (`api.py:337-393`): the
        unquantized model greedily generates `frames` frames per caption
        with CFG pairs; both rows of a pair take the prompt + delayed audio
        stream.  Returns (ids, codec ids, mask) tensors on the device."""
        cfg = self.config
        neg = t2m_prompt(T2M_NEGATIVE_CAPTION)
        ids, mask = self._tokenize([x for c in captions for x in (neg, t2m_prompt(c))])
        B2, Tt = ids.shape
        prefill, steps = dl.prepare_audio_prompt(
            [None] * (B2 // 2), num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
            delay_pattern=cfg.codec_delay_pattern)
        buf = pad_buffer(torch.as_tensor(prefill, device=self.device), frames)
        res = generate(
            self.params, cfg, torch.as_tensor(ids, device=self.device),
            torch.as_tensor(mask, device=self.device), None, buf, steps,
            torch.Generator(device=self.device).manual_seed(0),
            max_tokens=frames, min_tokens=frames, cfg_scale=10.0, temperature=1.0, top_p=1.0,
            cfg_filter_top_k=45, eos_prob_mul_factor=1.0, do_sample=False)
        n_pre = int(np.asarray(steps)[0])
        stream = np.concatenate([np.asarray(prefill)[:, :n_pre], res.codes.cpu().numpy()], 1)
        stream = np.repeat(stream, 2, axis=0)
        Tc = stream.shape[1]
        full_ids = np.concatenate(
            [ids, np.full((B2, Tc), cfg.codec_placeholder_value, np.int32)], axis=1)
        full_mask = np.concatenate([mask, np.ones((B2, Tc), np.int32)], axis=1)
        codec = np.zeros((B2, full_ids.shape[1], cfg.codec_channels), np.int32)
        codec[:, Tt:] = stream
        return tuple(torch.as_tensor(a, device=self.device) for a in (full_ids, codec, full_mask))

    def _gptq_quantize_experts(self, captions=None, frames: int = 64, group_size: int = 0,
                               max_calib_tokens: int = 4096) -> None:
        """Self-calibrated GPTQ of the expert FFNs (`api.py:337-393`).
        MUTATES self.params (expert leaves → int4 QTensors)."""
        from .ops.gptq import quantize_experts_int4_gptq

        t0 = time.perf_counter()
        ids, codec, mask = self._calibration_batch(captions or self.GPTQ_CALIB_CAPTIONS, frames)
        _sync(self.device)
        t1 = time.perf_counter()
        quantize_experts_int4_gptq(self.params, self.config, ids, codec_input_ids=codec,
                                   attention_mask=mask, group_size=group_size,
                                   max_calib_tokens=max_calib_tokens)
        _sync(self.device)
        self.load_timings.update(calibration_s=t1 - t0, gptq_s=time.perf_counter() - t1)

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
        kw = self.serving_dispatch(*input_ids.shape)
        if self.kv_cache_dtype:
            kw["kv_dtype"] = self.kv_cache_dtype
        res = gen_fn(
            self.params, cfg,
            torch.as_tensor(input_ids, device=self.device),
            torch.as_tensor(attention_mask, device=self.device),
            None, buf, prefill_steps, gen,
            max_tokens=max_tokens, min_tokens=min_tokens, cfg_scale=cfg_scale,
            temperature=temperature, top_p=top_p, cfg_filter_top_k=cfg_filter_top_k,
            eos_prob_mul_factor=eos_prob_mul_factor, do_sample=do_sample, timings=timings,
            **kw,
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

    def serving_dispatch(self, rows: int, T_text: int) -> dict:
        """The serving dispatch choice for `rows` CFG rows of `T_text` tokens
        (`api.py:484-500`): packed (packed_a8 with a8_compute) decode from
        64 rows at capacity ceil16(0.64 x rows), packed prefill from 1024
        tokens at ceil128(0.57 x tokens).  Without serving_mode, or below
        those sizes, nothing (dense dispatch; the decode takes the prefill's
        mode when only the prefill is packed, as in the JAX package)."""
        kw: dict = {}
        if self.serving_mode:
            pk = "packed_a8" if self.a8_compute else "packed"
            S_pre = rows * T_text
            if rows >= 64:
                kw.update(decode_dispatch_mode=pk, decode_capacity=_ceil_to(int(rows * 0.64), 16))
            if S_pre >= 1024:
                kw.update(dispatch_mode=pk, prefill_capacity=_ceil_to(int(S_pre * 0.57), 128))
        return kw

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
