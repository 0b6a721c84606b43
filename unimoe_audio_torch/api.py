"""UniMoEAudio — the user-facing task API of the port: text-to-music
(batched, streaming and self-speculative), voice-clone text-to-speech,
video+text-to-music, mixed-task batches and the continuous slot server.

Counterpart of `unimoe_audio_tpu/api.py`: the same prompt templates,
64-token left-padded buckets, CFG pairs and generation defaults, bf16 with
dense dispatch (`serving_mode=False`) or the quantized serving modes
(int8 / int4 / int4-gptq weights, a8 expert compute, the int8 KV cache,
capacity-packed dispatch) and their snapshots.  Weights load from a
directory (a serving snapshot, `model.jax.pkl`, or `config.json` with HF
safetensors shards) or are random from a seed (`allow_random=True`); the
DAC's from `dac_weights=` / DAC_WEIGHTS.  Runs on CUDA unless the caller
passes `device="cpu"`; without a GPU it raises rather than running on the
CPU.
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
from .models.model import align_codec_ids, init_model_params
from .parallel.comm import is_writer
from .tokenizer import SimpleTokenizer
from .train.peft import prefix_kv, virtual_embeds

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


def vt2m_prompt(video_span: str, caption: str) -> str:
    """The VT2M prompt layout: the video's span, then the music caption."""
    return SYSTEM_MESSAGE + INPUT_FORMAT.format(video_span + music_span(caption)) + AUDIO_START


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
    """Text-to-music, voice-clone text-to-speech and video+text-to-music."""

    MAX_TOKENS = 1000   # ≤ 20 s of audio at 50 frames/s
    MIN_TOKENS = 100

    def __init__(
        self,
        model_path: Optional[str] = None,
        device_id: int = 0,
        *,
        dtype: torch.dtype = torch.bfloat16,
        tokenizer=None,
        allow_random: bool = False,
        config: Optional[UniMoEAudioConfig] = None,
        dac_weights: Optional[str] = None,
        device=None,
        max_tokens: Optional[int] = None,
        min_tokens: Optional[int] = None,
        serving_mode=False,
        gptq_calibration: Optional[dict] = None,
        kv_cache_dtype: Optional[str] = None,
        a8_compute: bool = True,
    ):
        """model_path: a directory holding a serving snapshot
        (`save_serving_snapshot`, or the JAX package's `serving.jax.pkl`),
        whose params load already quantized; else `model.jax.pkl` (a
        converted checkpoint: the port's numpy-only file, or the JAX
        package's, whose bf16 leaves need ml_dtypes to unpickle); else
        `config.json` with `*.safetensors` shards (converted on load by
        `core/convert.py`), or with allow_random random weights of that
        config; else FileNotFoundError.  Without model_path, allow_random
        gives random weights from a fixed seed for `config` (default the
        tiny test config), the vision tower included where the config has
        one.  Floating weights are cast to dtype.

        device_id selects `cuda:{device_id}`; device (for example "cpu")
        overrides it.  tokenizer: any callable with the HF tokenizer's
        `__call__` surface; else the model directory's HF tokenizer where
        `transformers` imports, else with allow_random the development
        `SimpleTokenizer`.  dac_weights: a converted DAC weights file (else
        DAC_WEIGHTS, else `dac_model/weights_16khz.jax.pkl`); without one
        the DAC is random (16 kHz; the tiny DAC for configs with other than
        12 codec channels) under allow_random, and absent otherwise, when
        generation writes each stream's codes as `.wav.codes.npy`.

        serving_mode (`api.py:94-191`): True or "int8" quantizes the
        attention projections, expert FFNs, output heads and the vision
        tower's projections to per-channel int8, pads the expert FFNs to
        128 columns and sizes packed dispatch from the batch; "int4"
        requantizes the experts to int4; "int4-gptq" quantizes them with
        GPTQ against a greedy self-calibration run
        (`gptq_calibration`: {"captions", "frames", "group_size"}) first.
        kv_cache_dtype="int8" keeps the KV cache in int8.  a8_compute runs
        the packed expert FFNs in int8 (`packed_a8`) where serving selects
        packed dispatch.  `load_timings` holds the seconds of each stage."""
        if serving_mode not in SERVING_MODES:
            raise ValueError(f"serving_mode must be one of {SERVING_MODES}, got {serving_mode!r}")
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None or 'int8', got {kv_cache_dtype!r}")
        from .core.export import find_serving_snapshot, load_serving_snapshot

        self.device = resolve_device(device if device is not None else f"cuda:{device_id}")
        set_matmul_precision()
        self.MAX_TOKENS = max_tokens if max_tokens is not None else UniMoEAudio.MAX_TOKENS
        self.MIN_TOKENS = min_tokens if min_tokens is not None else UniMoEAudio.MIN_TOKENS
        self.load_timings: dict = {}
        t0 = time.perf_counter()
        snapshot = model_path is not None and find_serving_snapshot(model_path) is not None
        if snapshot:
            self.config, self.params, snap_mode, snap_kv = load_serving_snapshot(
                model_path, self.device)
            if serving_mode not in (False, snap_mode):
                raise ValueError(f"the snapshot was quantized as {snap_mode!r}; pass "
                                 f"serving_mode={snap_mode!r} or leave it out")
            serving_mode = snap_mode
            kv_cache_dtype = kv_cache_dtype or snap_kv
        else:
            self.config, self.params = self._load_model(
                model_path, dtype=dtype, allow_random=allow_random, config=config)
        _sync(self.device)
        self.load_timings["load_s"] = time.perf_counter() - t0
        self.serving_mode = serving_mode
        self.kv_cache_dtype = kv_cache_dtype
        self.a8_compute = a8_compute
        self.tokenizer = tokenizer or self._load_tokenizer(model_path)
        if self.tokenizer is None and allow_random:
            special = {t: 100 + i for i, t in enumerate(SPECIAL_TOKENS)}
            special["<|AUDIO_PLACEHOLDER|>"] = self.config.codec_placeholder_value
            special["<|vision_start|>"] = self.config.vision_start_token_id
            special["<|vision_end|>"] = self.config.vision_end_token_id
            special["<|video_pad|>"] = self.config.video_token_id
            self.tokenizer = SimpleTokenizer(
                vocab_size=min(self.config.text_config.vocab_size, 10000), special=special)
        self.dac = self._load_dac(dac_weights, allow_random)
        self.last_timings: dict = {}
        self.last_codes: List[np.ndarray] = []
        self.mesh = None
        if serving_mode and not snapshot:
            self._quantize(serving_mode, gptq_calibration or {})

    # ------------------------------------------------------------------
    # Loading (`api.py:215-290`)
    # ------------------------------------------------------------------
    def _load_model(self, model_path, *, dtype, allow_random, config):
        from .core.bridge import params_from_jax

        if model_path is not None:
            blob_path = os.path.join(model_path, "model.jax.pkl")
            if os.path.isfile(blob_path):
                import pickle

                from .core.export import _decode

                with open(blob_path, "rb") as f:
                    blob = pickle.load(f)
                cfg = UniMoEAudioConfig.from_dict(blob["config"])
                return cfg, params_from_jax(_decode(blob["params"]), cfg, self.device, dtype)
            cfg_json = os.path.join(model_path, "config.json")
            if os.path.isfile(cfg_json):
                cfg = UniMoEAudioConfig.from_json(cfg_json)
                if any(f.endswith(".safetensors") for f in os.listdir(model_path)):
                    from .core.convert import convert_model_state_dict, load_hf_safetensors

                    tree = convert_model_state_dict(load_hf_safetensors(model_path), cfg)
                    return cfg, params_from_jax(tree, cfg, self.device, dtype)
                if allow_random:
                    return cfg, init_model_params(cfg, seed=0, dtype=dtype, device=self.device)
            raise FileNotFoundError(f"No model weights found under {model_path} (looked for "
                                    "model.jax.pkl / *.safetensors).")
        if not allow_random:
            raise ValueError("model_path is required unless allow_random=True")
        cfg = config or tiny_test_config()
        return cfg, init_model_params(cfg, seed=0, dtype=dtype, device=self.device,
                                      with_vision=True)

    @staticmethod
    def _load_tokenizer(model_path):
        """The model directory's HF tokenizer (left padding, every special
        token one id), or None without a directory or `transformers`."""
        if model_path is None:
            return None
        try:
            from transformers import AutoTokenizer

            tok = AutoTokenizer.from_pretrained(model_path, padding_side="left")
            assert all(len(tok([t]).input_ids[0]) == 1 for t in SPECIAL_TOKENS), \
                "special tokens must each map to a single id"
            return tok
        except Exception:
            return None

    def _load_dac(self, dac_weights, allow_random):
        """The Dac, or None when no weights are found and allow_random is off."""
        cfg = None
        if allow_random and self.config.codec_channels != 12:
            cfg = dataclasses.replace(tiny_dac_config(), n_codebooks=self.config.codec_channels)
        try:
            return Dac(dac_weights, allow_random=allow_random, config=cfg, device=self.device)
        except FileNotFoundError:
            return None

    def _quantize(self, serving_mode, gptq_calibration: dict) -> None:
        """The JAX constructor's pipeline (`api.py:172-191`): GPTQ experts
        first for "int4-gptq" (the int8 pass leaves QTensor leaves alone),
        int8 in place, the expert FFNs padded, then int4 for "int4"; the
        vision tower, where present, in int8."""
        from .ops.quant import (pad_expert_ffn, quantize_model_params_inplace,
                                quantize_vision_params, requantize_experts_int4_inplace)

        if serving_mode == "int4-gptq":
            self._gptq_quantize_experts(**gptq_calibration)
        t0 = time.perf_counter()
        quantize_model_params_inplace(self.params)
        pad_expert_ffn(self.params)
        if serving_mode == "int4":
            requantize_experts_int4_inplace(self.params)
        if "vision" in self.params:
            self.params["vision"] = quantize_vision_params(self.params["vision"])
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
        if self.tokenizer is None:
            raise RuntimeError("No tokenizer available: pass tokenizer= or a model_path with "
                               "tokenizer files.")
        out = self.tokenizer(texts, add_special_tokens=False, padding=True, return_tensors="np")
        ids = np.asarray(out["input_ids"], dtype=np.int32)
        mask = np.asarray(out["attention_mask"], dtype=np.int32)
        # Bucket the text length, padding on the LEFT.
        T = _bucket(ids.shape[1])
        if T > ids.shape[1]:
            pad_id = getattr(self.tokenizer, "pad_token_id", 0) or 0
            pad = np.full((ids.shape[0], T - ids.shape[1]), pad_id, dtype=np.int32)
            ids = np.concatenate([pad, ids], axis=1)
            mask = np.concatenate([np.zeros_like(pad), mask], axis=1)
        return ids, mask

    def _preprocess_codec(self, codec) -> np.ndarray:
        """Voice-prompt codes [T, C] → [T + max_delay + 1, C] with each
        channel's BOS run-in, one EOS, then PAD."""
        return dl.preprocess_codec(
            np.asarray(codec), delay_pattern=self.config.codec_delay_pattern,
            num_channels=self.config.codec_channels, bos_value=self.config.codec_bos_value,
            eos_value=self.config.codec_eos_value, pad_value=self.config.codec_pad_value)

    @torch.inference_mode()
    def _generate_core(
        self,
        input_ids: np.ndarray,
        attention_mask: np.ndarray,
        codec_input_ids: Optional[np.ndarray],
        save_name: str,
        rebuild_codec=None,
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
        decode_emit: Optional[bool] = None,
        visual_embeds=None,
        visual_mask=None,
        prefill_position_ids=None,
        rope_deltas=None,
        max_tokens_vec=None,
        sample_seeds=None,
    ) -> List[str]:
        """Generate codes for CFG-interleaved rows, decode them to wavs
        (`api.py:398-569`).  cfg_scale / temperature / top_p /
        eos_prob_mul_factor / min_tokens take a float or one value per
        sample, max_tokens_vec [B] per-sample budgets and sample_seeds [B]
        per-sample seeds (`generate_mixed`).  codec_input_ids: the flat [N, C] codec rows of
        the prompts' placeholders, in reading order (`align_codec_ids`).
        The vision inputs (arrays or tensors: visual_embeds [2B, T, D],
        visual_mask [2B, T], prefill_position_ids [3, 2B, T], rope_deltas
        [2B, 1]) go to the loop.
        Without a DAC each stream's codes go to `.wav.codes.npy` files;
        with rebuild_codec [T, C] its decode is written once per stream as
        `rebuild_{save_name}_{i}.wav`.  Keeps the per-stream codes [T_i, C]
        in `self.last_codes` and fills `self.last_timings` with the device-
        synchronised seconds of the prefill, the decode and the DAC.

        PEFT adapters in `params["peft"]` act here as in training
        (`api.py:430-460`): prefix tuning's keys and values go into the
        cache ahead of the prompt; prompt and P-tuning prepend n soft tokens
        to every row (id 0, mask 1), carried through the loop's
        visual_embeds scatter; with explicit vision positions they are
        refused."""
        cfg = self.config
        max_tokens = max_tokens if max_tokens is not None else self.MAX_TOKENS
        min_tokens = min_tokens if min_tokens is not None else self.MIN_TOKENS
        peft_prefix = None
        if "peft" in self.params:
            peft_prefix = prefix_kv(self.params["peft"], cfg)
            virt = virtual_embeds(self.params["peft"])
            if virt is not None:
                assert prefill_position_ids is None, (
                    "soft-prompt adapters with explicit vision positions are not supported yet")
                n, R = virt.shape[0], input_ids.shape[0]
                input_ids = np.concatenate([np.zeros((R, n), input_ids.dtype), input_ids], 1)
                attention_mask = np.concatenate(
                    [np.ones((R, n), attention_mask.dtype), attention_mask], 1)
                ve = torch.zeros(*input_ids.shape, virt.shape[-1], dtype=torch.float32,
                                 device=self.device)
                vm = torch.zeros(input_ids.shape, dtype=torch.int32, device=self.device)
                ve[:, :n] = virt.float()
                vm[:, :n] = 1
                if visual_embeds is not None:
                    ve[:, n:] = torch.as_tensor(visual_embeds, device=self.device).float()
                    vm[:, n:] = torch.as_tensor(visual_mask, device=self.device)
                visual_embeds, visual_mask = ve, vm
        batch_size = input_ids.shape[0] // 2
        prefill, prefill_steps = dl.prepare_audio_prompt(
            [None] * batch_size, num_channels=cfg.codec_channels,
            bos_value=cfg.codec_bos_value, delay_pattern=cfg.codec_delay_pattern)
        buf = pad_buffer(torch.as_tensor(prefill, device=self.device), max_tokens)
        aligned = None
        if codec_input_ids is not None:
            aligned = torch.as_tensor(
                align_codec_ids(input_ids, codec_input_ids, cfg.codec_placeholder_value),
                device=self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed if seed is not None else int(time.time() * 1e3) % (2 ** 31))
        # Long generations grow the KV cache chunk by chunk.
        gen_fn = generate_chunked if max_tokens >= 512 else generate
        timings: dict = {}
        kw = self.serving_dispatch(*input_ids.shape)
        if self.kv_cache_dtype:
            kw["kv_dtype"] = self.kv_cache_dtype
        for k, v in (("visual_embeds", visual_embeds), ("visual_mask", visual_mask),
                     ("prefill_position_ids", prefill_position_ids),
                     ("rope_deltas", rope_deltas)):
            if v is not None:
                kw[k] = torch.as_tensor(v, device=self.device)
        res = gen_fn(
            self.params, cfg,
            torch.as_tensor(input_ids, device=self.device),
            torch.as_tensor(attention_mask, device=self.device),
            aligned, buf, prefill_steps, gen,
            max_tokens=max_tokens, min_tokens=min_tokens, cfg_scale=cfg_scale,
            temperature=temperature, top_p=top_p, cfg_filter_top_k=cfg_filter_top_k,
            eos_prob_mul_factor=eos_prob_mul_factor, do_sample=do_sample, timings=timings,
            decode_emit=decode_emit, max_tokens_vec=max_tokens_vec, sample_seeds=sample_seeds,
            prefix_kv=peft_prefix, **kw,
        )
        codes = res.codes.cpu().numpy()
        lengths = res.lengths.cpu().numpy()
        timings.update(steps=res.steps, lengths=lengths.tolist(), T_text=input_ids.shape[1])
        audios = dl.generate_output(codes, lengths, pad_value=cfg.codec_pad_value,
                                    delay_pattern=cfg.codec_delay_pattern)

        t0 = time.perf_counter()
        writer = is_writer()                   # on a mesh, rank 0 writes the files
        if writer:
            os.makedirs(output_dir, exist_ok=True)
        if self.dac is not None:
            output_paths = [os.path.join(output_dir, f"generated_{save_name}_{i}.wav")
                            for i in range(len(audios))]
            if writer:
                self.dac.decode_batch([frames.T for frames in audios], output_paths,
                                      min_duration=1)
        else:
            output_paths = []
            for i, frames in enumerate(audios):
                p = os.path.join(output_dir, f"generated_{save_name}_{i}.wav.codes.npy")
                if writer:
                    np.save(p, frames)
                output_paths.append(p)
        if rebuild_codec is not None and self.dac is not None and writer:
            rebuild = np.asarray(rebuild_codec).T[None]
            for i in range(len(audios)):
                self.dac.decode(rebuild, save_path=os.path.join(
                    output_dir, f"rebuild_{save_name}_{i}.wav"))
        timings["dac_s"] = time.perf_counter() - t0
        self.last_timings = timings
        self.last_codes = audios
        return output_paths

    def use_mesh(self, mesh) -> None:
        """Serve on a (data, expert, model) mesh (`parallel/mesh.py`): the
        params become this rank's shard (`shard_params`, quantized leaves
        included) and the mesh the process's active one; every rank then
        takes the same requests and computes the same tokens, and rank 0
        writes the files.  Quantize before: a serving snapshot or GPTQ
        calibration works on the whole model."""
        from .parallel.mesh import set_mesh, shard_params

        self.params = shard_params(self.params, mesh, self.config)
        self.mesh = mesh
        set_mesh(mesh)

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
        rebuild_codec=None,
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
        decode_emit: Optional[bool] = None,
        **_ignored,
    ) -> List[str]:
        """Text-to-music (`api.py:574-617`): one wav per caption.
        max/min_audio_seconds count 50 frames per second; other keywords
        are ignored, as the JAX package ignores them."""
        mt = int(max_audio_seconds * 50) if max_audio_seconds is not None else None
        mn = int(min_audio_seconds * 50) if min_audio_seconds is not None else None
        caption = [caption] if isinstance(caption, str) else [c for c in caption if c.strip()]
        if not caption or not all(c.strip() for c in caption):
            print("Please enter a music description.")
            return []
        ids, mask = self._tokenize(
            [x for c in caption for x in (t2m_prompt(T2M_NEGATIVE_CAPTION), t2m_prompt(c))])
        t0 = time.time()
        paths = self._generate_core(
            ids, mask, None, save_name, rebuild_codec, output_dir, cfg_scale, temperature, top_p,
            cfg_filter_top_k, eos_prob_mul_factor, do_sample, seed,
            max_tokens=mt, min_tokens=mn, decode_emit=decode_emit)
        print(f"Music generation completed! Time: {time.time() - t0:.2f}s")
        return paths

    def text_to_music_stream(
        self,
        caption: str,
        *,
        chunk_frames: int = 25,
        cfg_scale: float = 10.0,
        temperature: float = 1.0,
        top_p: float = 1.0,
        cfg_filter_top_k: int = 45,
        eos_prob_mul_factor: float = 0.6,
        seed: Optional[int] = None,
    ):
        """Streaming T2M (`api.py:619-648`): yields {"frames", "audio",
        "lengths", "done"} chunks of `chunk_frames` frames while decoding
        continues, up to the instance's MAX_TOKENS frames."""
        from .generate.streaming import generate_stream

        ids, mask = self._tokenize([t2m_prompt(T2M_NEGATIVE_CAPTION), t2m_prompt(caption)])
        gen = torch.Generator(device=self.device).manual_seed(seed if seed is not None else 0)
        with torch.inference_mode():
            yield from generate_stream(
                self.params, self.config, ids, mask, None, gen,
                max_tokens=self.MAX_TOKENS, min_tokens=self.MIN_TOKENS,
                chunk_frames=chunk_frames, cfg_scale=cfg_scale, temperature=temperature,
                top_p=top_p, cfg_filter_top_k=cfg_filter_top_k,
                eos_prob_mul_factor=eos_prob_mul_factor, dac=self.dac,
                kv_dtype=self.kv_cache_dtype)

    def text_to_speech(
        self,
        caption: Union[str, List[str]] = None,
        prompt_text: str = None,
        prompt_wav: Optional[str] = None,
        save_name: str = "speech",
        prompt_codec=None,
        rebuild_codec=None,
        output_dir: str = "./",
        cfg_scale: float = 1.0,
        temperature: float = 1.0,
        top_p: float = 1.0,
        cfg_filter_top_k: int = 45,
        eos_prob_mul_factor: float = 1.0,
        do_sample: bool = True,
        seed: Optional[int] = None,
        transcription: Union[str, List[str], None] = None,
        prompt_transcription: Optional[str] = None,
        max_audio_seconds: Optional[float] = None,
        min_audio_seconds: Optional[float] = None,
        **_ignored,
    ) -> List[str]:
        """Voice-clone TTS (`api.py:650-724`): one wav per target text in
        the voice of prompt_wav (encoded by the DAC) or of prompt_codec
        ([T, C] codes), whose transcript is prompt_text.  The prompt's
        codes, laid out with their BOS run-in and EOS, fill the
        `<|AUDIO_PLACEHOLDER|>` slots of every CFG row; the negative row has
        no target text.  transcription / prompt_transcription are other
        spellings of caption / prompt_text; max/min_audio_seconds count 50
        frames per second.  `last_timings["dac_encode_s"]` holds the
        prompt's encode seconds (0 with prompt_codec)."""
        caption = caption if caption is not None else transcription
        prompt_text = prompt_text if prompt_text is not None else prompt_transcription
        mt = int(max_audio_seconds * 50) if max_audio_seconds is not None else None
        mn = int(min_audio_seconds * 50) if min_audio_seconds is not None else None
        caption = [caption] if isinstance(caption, str) else [c for c in caption if c.strip()]
        if not caption or not all(c.strip() for c in caption):
            print("Please enter the target text.")
            return []
        encode_s = 0.0
        if prompt_codec is None:
            if prompt_wav is None:
                print("Please provide a reference audio file.")
                return []
            if self.dac is None:
                raise RuntimeError("DAC weights unavailable: cannot encode prompt_wav")
            t0 = time.perf_counter()
            prompt_codec = self.dac.encode(prompt_wav)
            encode_s = time.perf_counter() - t0
        if not str(prompt_text).strip():
            print("Please enter the reference audio transcript.")
            return []

        codec_ids = self._preprocess_codec(prompt_codec)                    # [P, C]
        text_input = [self._tts_prompt(prompt_text, codec_ids.shape[0], x)
                      for c in caption for x in ("", c)]
        ids, mask = self._tokenize(text_input)
        # The flat codec rows, once per CFG row.
        flat = np.tile(codec_ids, (len(text_input), 1))
        t0 = time.time()
        paths = self._generate_core(
            ids, mask, flat, save_name, rebuild_codec, output_dir, cfg_scale, temperature, top_p,
            cfg_filter_top_k, eos_prob_mul_factor, do_sample, seed,
            max_tokens=mt, min_tokens=mn)
        self.last_timings["dac_encode_s"] = encode_s
        print(f"Speech generation completed! Time: {time.time() - t0:.2f}s")
        return paths

    def video_text_to_music(
        self,
        video,
        caption: Union[str, List[str]],
        save_name: str = "video_music",
        rebuild_codec=None,
        fps: int = 1,
        sampling_fps: int = 1,
        total_pixels: int = 3 * 28 * 28,
        max_frames: Optional[int] = 1,
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
        **_ignored,
    ) -> List[str]:
        """Video+text-to-music (`api.py:726-831`): one wav per (video,
        caption).  A video is a file path (frames sampled at sampling_fps,
        at most max_frames, resized under total_pixels; needs OpenCV) or
        pre-extracted frames, a float array [T, 3, H, W] in [0, 255], taken
        as they are.  Each video goes through the vision tower once; its
        features fill the `<|video_pad|>` slots of both rows of its CFG
        pair, the prefill takes 3-D mRoPE positions (`get_rope_index`,
        second_per_grid_t = temporal_patch_size / fps) and decode starts at
        T_text + rope_deltas.  max/min_audio_seconds count 50 frames per
        second.  Without a vision tower it warns and generates from the
        captions (`text_to_music`), as the JAX package does.
        `last_timings["vision_s"]` holds each tower call's device-
        synchronised seconds."""
        video = [video] if isinstance(video, str) else list(video)
        caption = [caption] if isinstance(caption, str) else caption
        assert len(video) == len(caption), "The number of videos and captions must match"
        if self.config.vision_config is None or "vision" not in self.params:
            print("[warning] model has no vision tower; generating from captions only")
            return self.text_to_music(
                caption, save_name=save_name, rebuild_codec=rebuild_codec,
                output_dir=output_dir, cfg_scale=cfg_scale, temperature=temperature,
                top_p=top_p, cfg_filter_top_k=cfg_filter_top_k,
                eos_prob_mul_factor=eos_prob_mul_factor, do_sample=do_sample, seed=seed,
                max_audio_seconds=max_audio_seconds, min_audio_seconds=min_audio_seconds)
        from .models.model import get_rope_index

        vcfg = self.config.vision_config
        mt = int(max_audio_seconds * 50) if max_audio_seconds is not None else None
        mn = int(min_audio_seconds * 50) if min_audio_seconds is not None else None
        text_input, feats, grids, spgts, vision_s = [], [], [], [], []
        for v, c in zip(video, caption):
            f, grid, span, secs = self._video_features(v, sampling_fps, max_frames, total_pixels)
            vision_s.append(secs)
            for cap in (T2M_NEGATIVE_CAPTION, c):        # the CFG pair shares the video
                text_input.append(vt2m_prompt(span, cap))
                feats.append(f)
                grids.append(grid)
                spgts.append(vcfg.temporal_patch_size / fps)
        ids, mask = self._tokenize(text_input)
        visual_embeds, visual_mask = self._scatter_video(ids, feats)
        position_ids, deltas = get_rope_index(
            ids, self.config, video_grid_thw=np.stack(grids), second_per_grid_ts=spgts,
            attention_mask=mask)
        t0 = time.time()
        paths = self._generate_core(
            ids, mask, None, save_name, rebuild_codec, output_dir, cfg_scale, temperature, top_p,
            cfg_filter_top_k, eos_prob_mul_factor, do_sample, seed,
            max_tokens=mt, min_tokens=mn, visual_embeds=visual_embeds,
            visual_mask=visual_mask, prefill_position_ids=position_ids, rope_deltas=deltas)
        self.last_timings["vision_s"] = vision_s
        print(f"Video music generation completed! Time: {time.time() - t0:.2f}s")
        return paths

    # ------------------------------------------------------------------
    # Shared by the VT2M entry points
    # ------------------------------------------------------------------
    def _video_features(self, video, sampling_fps, max_frames, total_pixels):
        """One video through the tower: a file path (frames sampled at
        sampling_fps, at most max_frames, resized under total_pixels; needs
        OpenCV) or pre-extracted frames [T, 3, H, W] in [0, 255].  Returns
        (features [tokens, D] on the device, grid [3], the prompt's video
        span, the tower call's device-synchronised seconds)."""
        from .apps.video import extract_frames, frame_process, video_to_patches
        from .models import vision

        vcfg = self.config.vision_config
        if isinstance(video, str):
            pixels = frame_process(extract_frames(video, sampling_fps, max_frames),
                                   total_pixels=total_pixels, min_pixels=28 * 28)
        else:
            pixels = np.asarray(video, dtype=np.float32)
        patches, grid = video_to_patches(
            pixels, patch_size=vcfg.patch_size, temporal_patch_size=vcfg.temporal_patch_size,
            merge_size=vcfg.spatial_merge_size)
        t0 = time.perf_counter()
        with torch.inference_mode():
            feats = vision.vision_forward(self.params["vision"],
                                          torch.as_tensor(patches, device=self.device),
                                          grid[None], vcfg)
        _sync(self.device)
        n_tok = patches.shape[0] // vcfg.spatial_merge_size ** 2
        span = "<|vision_start|>" + "<|video_pad|>" * n_tok + "<|vision_end|>"
        return feats, grid, span, time.perf_counter() - t0

    def _scatter_video(self, ids: np.ndarray, feats):
        """The per-row features (None for a row without video) at the
        `<|video_pad|>` slots of ids [R, T]: (visual_embeds [R, T, D] on
        the device, visual_mask [R, T] numpy)."""
        visual_mask = (ids == self.config.video_token_id).astype(np.int32)
        like = next(f for f in feats if f is not None)
        visual_embeds = torch.zeros(*ids.shape, like.shape[-1], dtype=like.dtype,
                                    device=self.device)
        for r, f in enumerate(feats):
            slots = np.flatnonzero(visual_mask[r])
            n = 0 if f is None else f.shape[0]
            assert len(slots) == n, f"video tokens {len(slots)} != features {n}"
            if n:
                visual_embeds[r, torch.as_tensor(slots, device=self.device)] = f
        return visual_embeds, visual_mask

    # ------------------------------------------------------------------
    # Self-speculative decoding
    # ------------------------------------------------------------------
    def text_to_music_speculative(
        self,
        caption: str,
        *,
        save_name: str = "music_spec",
        output_dir: str = "./",
        cfg_scale: float = 10.0,
        eos_prob_mul_factor: float = 0.6,
        spec_len: int = 4,
        draft_layers: Optional[int] = None,
        max_audio_seconds: Optional[float] = None,
        min_audio_seconds: Optional[float] = None,
    ) -> List[str]:
        """Single-stream T2M by self-speculative greedy decoding
        (`api.py:833-886`): the codes of `text_to_music(do_sample=False,
        decode_emit=False)`, with the full model verifying spec_len frames
        per forward (`generate/speculative.py`).  draft_layers defaults to
        a quarter of the layers.  `last_timings` holds the prefill and
        decode seconds, frames, cycles and accept_rate."""
        from .generate.speculative import speculative_generate

        cfg = self.config
        mt = int(max_audio_seconds * 50) if max_audio_seconds else self.MAX_TOKENS
        mn = int(min_audio_seconds * 50) if min_audio_seconds else self.MIN_TOKENS
        draft_layers = draft_layers or max(1, cfg.text_config.num_hidden_layers // 4)
        ids, mask = self._tokenize([t2m_prompt(T2M_NEGATIVE_CAPTION), t2m_prompt(caption)])
        prefill, steps = dl.prepare_audio_prompt(
            [None], num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
            delay_pattern=cfg.codec_delay_pattern)
        timings: dict = {}
        res = speculative_generate(
            self.params, cfg, torch.as_tensor(ids, device=self.device),
            torch.as_tensor(mask, device=self.device), None,
            pad_buffer(torch.as_tensor(prefill, device=self.device), mt), steps,
            max_tokens=mt, min_tokens=mn, cfg_scale=cfg_scale,
            eos_prob_mul_factor=eos_prob_mul_factor, spec_len=spec_len,
            draft_layers=draft_layers, timings=timings, kv_dtype=self.kv_cache_dtype,
            **self.serving_dispatch(*ids.shape))
        audios = dl.generate_output(res.codes.cpu().numpy(), res.lengths.cpu().numpy(),
                                    pad_value=cfg.codec_pad_value,
                                    delay_pattern=cfg.codec_delay_pattern)
        timings.update(frames=res.frames, cycles=res.cycles, accept_rate=res.accept_rate,
                       lengths=res.lengths.cpu().tolist(), T_text=ids.shape[1])
        self.last_timings = timings
        self.last_codes = audios
        return self._write_streams(audios, output_dir, save_name)

    def _write_streams(self, audios, output_dir: str, save_name: str, names=None) -> List[str]:
        """Each stream's codes [T_i, C] as `generated_{save_name}_{name}.wav`
        (one DAC decode per stream, at least 1 s), or as `.wav.codes.npy`
        without a DAC; on a mesh rank 0 writes them."""
        writer = is_writer()
        if writer:
            os.makedirs(output_dir, exist_ok=True)
        out = []
        for i, frames in enumerate(audios):
            path = os.path.join(output_dir,
                                f"generated_{save_name}_{i if names is None else names[i]}.wav")
            if self.dac is None:
                path += ".codes.npy"
            if writer and self.dac is not None:
                self.dac.decode(frames.T[None], save_path=path, min_duration=1)
            elif writer:
                np.save(path, frames)
            out.append(path)
        return out

    # ------------------------------------------------------------------
    # Continuous batching (apps/continuous.py)
    # ------------------------------------------------------------------
    def continuous_server(self, *, slots: int = 4, t_text: int = 128,
                          horizon: Optional[int] = None, chunk_frames: int = 64,
                          do_sample: bool = True, deterministic: bool = False):
        """A SlotServer over this model's params (`api.py:892-930`): feed it
        `make_slot_request`s, turn its results into wavs with
        `decode_slot_results`.  A serving-mode server of 64 or more CFG rows
        (2 x slots) decodes with capacity-packed dispatch, as
        `_generate_core` does, and says that a request's output may then
        depend on the requests beside it; deterministic=True keeps dense,
        dropless dispatch.  The default horizon is MAX_TOKENS + 512 (a
        voice prompt's delayed frames) + 4 chunks."""
        from .apps.continuous import SlotServer

        dispatch_kw = {}
        S_dec = 2 * slots
        if not deterministic and self.serving_mode and S_dec >= 64:
            dispatch_kw["decode_dispatch_mode"] = "packed_a8" if self.a8_compute else "packed"
            dispatch_kw["decode_capacity"] = _ceil_to(int(S_dec * 0.64), 16)
            print(f"continuous_server: slots={slots} uses capacity-packed decode dispatch "
                  "(aggregate-throughput config); outputs may vary with co-resident load — "
                  "pass deterministic=True for dropless per-request-reproducible serving")
        return SlotServer(
            self.params, self.config, slots=slots, t_text=t_text,
            horizon=horizon or (self.MAX_TOKENS + 512 + 4 * chunk_frames),
            chunk_frames=chunk_frames, do_sample=do_sample, kv_dtype=self.kv_cache_dtype,
            **dispatch_kw)

    def make_slot_request(self, task: str = "text_to_music", *, caption: str,
                          prompt_text: Optional[str] = None, prompt_wav: Optional[str] = None,
                          prompt_codec=None, video=None, sampling_fps: int = 2,
                          max_frames: int = 16, seed: int = 0,
                          max_audio_seconds: Optional[float] = None,
                          min_audio_seconds: Optional[float] = None,
                          cfg_scale: Optional[float] = None, temperature: float = 1.0,
                          top_p: float = 1.0, eos_prob_mul_factor: Optional[float] = None,
                          rid=None):
        """A SlotRequest for one task (`api.py:932-1052`), with the prompt
        templates, tokenization, voice-prompt codes and video front end of
        the task methods.  A VT2M request's features stay on the device."""
        from .apps.continuous import SlotRequest

        cfg = self.config
        task = self.TASK_ALIASES.get(task, task)
        if task not in self.MIXED_DEFAULTS:
            raise ValueError(f"unsupported continuous task: {task}")
        d = self.MIXED_DEFAULTS[task]
        cfg_scale = d["cfg_scale"] if cfg_scale is None else cfg_scale
        eosf = d["eos_prob_mul_factor"] if eos_prob_mul_factor is None else eos_prob_mul_factor
        vision_kw = {}
        codec_flat = None
        if task == "video_text_to_music":
            if video is None or "vision" not in self.params:
                raise ValueError("VT2M requests need video= and a vision tower")
            from .models.model import get_rope_index

            vcfg = cfg.vision_config
            feats, grid, span, _ = self._video_features(video, sampling_fps, max_frames,
                                                        20480 * 28 * 28)
            ids, mask = self._tokenize([vt2m_prompt(span, c)
                                        for c in (T2M_NEGATIVE_CAPTION, caption)])
            ve, vm = self._scatter_video(ids, [feats, feats])
            position_ids, deltas = get_rope_index(
                ids, cfg, video_grid_thw=np.stack([grid, grid]),
                second_per_grid_ts=[vcfg.temporal_patch_size / sampling_fps] * 2,
                attention_mask=mask)
            vision_kw = dict(visual_embeds=ve, visual_mask=vm,
                             prefill_position_ids=np.asarray(position_ids),
                             rope_deltas=np.asarray(deltas).reshape(-1))
        elif task == "text_to_music":
            ids, mask = self._tokenize([t2m_prompt(T2M_NEGATIVE_CAPTION), t2m_prompt(caption)])
        else:
            if prompt_codec is None:
                if prompt_wav is None or self.dac is None:
                    raise ValueError("TTS requests need prompt_codec or prompt_wav+DAC")
                prompt_codec = self.dac.encode(prompt_wav)
            codec_flat = self._preprocess_codec(prompt_codec)                  # [P, C]
            ids, mask = self._tokenize([self._tts_prompt(prompt_text, codec_flat.shape[0], x)
                                        for x in ("", caption)])

        prefill, steps = dl.prepare_audio_prompt(
            [None], num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
            delay_pattern=cfg.codec_delay_pattern)
        mt = int(max_audio_seconds * 50) if max_audio_seconds is not None else self.MAX_TOKENS
        mn = (int(min_audio_seconds * 50) if min_audio_seconds is not None
              else min(self.MIN_TOKENS, mt))
        return SlotRequest(
            input_ids=np.asarray(ids), attention_mask=np.asarray(mask),
            prefill=np.asarray(prefill[0]), prefill_steps=int(steps[0]),
            codec_flat=codec_flat, max_tokens=mt, min_tokens=mn, cfg_scale=cfg_scale,
            temperature=temperature, top_p=top_p, eos_prob_mul_factor=eosf, seed=seed,
            rid=rid, **vision_kw)

    def decode_slot_results(self, results, output_dir: str = "./",
                            save_name: str = "continuous") -> List[str]:
        """The SlotResults' wavs (delay revert + DAC; `api.py:1054-1071`),
        named by each result's rid."""
        cfg = self.config
        audios = [dl.generate_output(r.codes[None], np.asarray([r.length]),
                                     pad_value=cfg.codec_pad_value,
                                     delay_pattern=cfg.codec_delay_pattern)[0] for r in results]
        return self._write_streams(audios, output_dir, save_name, names=[r.rid for r in results])

    def _tts_prompt(self, prompt_text, n_placeholders: int, target: str) -> str:
        """The voice-clone prompt: the prompt's transcript, n placeholder
        slots for its codes, the target text."""
        return (SYSTEM_MESSAGE + INPUT_FORMAT.format(
            "<|SPEECH_PROMPT_START|>" + str(prompt_text) + "<|SPEECH_PROMPT_END|>"
            + "<|VOICE_PROMPT_START|>" + "<|AUDIO_PLACEHOLDER|>" * n_placeholders
            + "<|VOICE_PROMPT_END|>" + "<|SPEECH_START|>" + target + "<|SPEECH_END|>")
            + AUDIO_START)

    # ------------------------------------------------------------------
    # Mixed-task batches (one decode batch for TTS / T2M / VT2M requests)
    # ------------------------------------------------------------------
    # Per-task defaults of generate_mixed and make_slot_request.
    MIXED_DEFAULTS = {
        "text_to_music": dict(cfg_scale=10.0, eos_prob_mul_factor=0.6),
        "text_to_speech": dict(cfg_scale=1.0, eos_prob_mul_factor=1.0),
        "video_text_to_music": dict(cfg_scale=10.0, eos_prob_mul_factor=0.6),
    }
    TASK_ALIASES = {"t2m": "text_to_music", "tts": "text_to_speech",
                    "vt2m": "video_text_to_music"}

    def check_mixed_request(self, r: dict) -> None:
        """Raise ValueError if request `r` of `generate_mixed` cannot run on
        this model: an unknown task, a TTS request without a prompt (or a
        prompt_wav that is missing or not a wav, or no DAC to encode it), a
        VT2M request without a video or a vision tower, or a video file that
        is missing or cannot be read here (no OpenCV).  Checked before any
        device work, so that a bad request fails on its own."""
        import wave

        task = r.get("task")
        if task not in self.MIXED_DEFAULTS:
            raise ValueError(f"unknown task: {task}")
        if task == "text_to_speech" and r.get("prompt_codec") is None:
            wav = r.get("prompt_wav")
            if wav is None:
                raise ValueError("text_to_speech requires prompt_wav or prompt_codec")
            if self.dac is None:
                raise ValueError("prompt_wav given but no DAC codec is loaded")
            try:
                with wave.open(str(wav), "rb"):
                    pass
            except (OSError, EOFError, wave.Error) as e:
                raise ValueError(f"prompt_wav {wav!r} is not a readable wav: {e}") from e
        if task == "video_text_to_music":
            video = r.get("video")
            if video is None:
                raise ValueError("video_text_to_music requires video")
            if self.config.vision_config is None or "vision" not in self.params:
                raise ValueError("video_text_to_music requires a model with a vision tower")
            if isinstance(video, str):
                from .apps.video import _cv2

                if not os.path.isfile(video):
                    raise ValueError(f"video {video!r} is not a file")
                try:
                    _cv2()
                except ImportError as e:
                    raise ValueError(str(e)) from e

    def generate_mixed(self, requests: List[dict], *, output_dir: str = "./",
                       save_name: str = "mixed", seed: Optional[int] = None,
                       do_sample: bool = True) -> List[str]:
        """Heterogeneous requests as ONE generation batch
        (`api.py:1073-1221`).  Each request dict has "task" (text_to_music,
        text_to_speech or video_text_to_music), that task's inputs
        (caption; prompt_text with prompt_codec or prompt_wav; video with
        sampling_fps, max_frames, total_pixels, fps) and optionally its own
        cfg_scale / temperature / top_p / eos_prob_mul_factor /
        max_audio_seconds / min_audio_seconds / seed, which ride the batch
        as per-sample vectors.  A request's seed defaults to seed + its
        index; its draws do not depend on the other requests (dense
        dispatch).  Returns one path per request, in order;
        `last_timings["vision_s"]` holds the tower calls' seconds."""
        cfg = self.config
        texts, codec_rows, feats, grids, spgts, vision_s = [], [], [], [], [], []
        p_cfg, p_temp, p_topp, p_eosf, p_min, p_max, p_seed = [], [], [], [], [], [], []
        base_seed = seed if seed is not None else int(time.time() * 1e3) % (2 ** 31)
        for r in requests:
            self.check_mixed_request(r)
        for r in requests:
            task = r["task"]
            d = self.MIXED_DEFAULTS[task]
            p_cfg.append(float(r.get("cfg_scale", d["cfg_scale"])))
            p_temp.append(float(r.get("temperature", 1.0)))
            p_topp.append(float(r.get("top_p", 1.0)))
            p_eosf.append(float(r.get("eos_prob_mul_factor", d["eos_prob_mul_factor"])))
            p_min.append(int(r.get("min_audio_seconds", self.MIN_TOKENS / 50) * 50))
            p_max.append(int(r.get("max_audio_seconds", self.MAX_TOKENS / 50) * 50))
            p_seed.append(int(r.get("seed", base_seed + len(p_seed))))
            if task == "text_to_music":
                texts += [t2m_prompt(T2M_NEGATIVE_CAPTION), t2m_prompt(r["caption"])]
                feats += [None, None]
            elif task == "text_to_speech":
                prompt_codec = r.get("prompt_codec")
                if prompt_codec is None:
                    prompt_codec = self.dac.encode(r["prompt_wav"])
                codec_ids = self._preprocess_codec(prompt_codec)                # [P, C]
                texts += [self._tts_prompt(r["prompt_text"], codec_ids.shape[0], x)
                          for x in ("", r["caption"])]
                codec_rows += [codec_ids, codec_ids]                            # one per CFG row
                feats += [None, None]
            else:
                vcfg = cfg.vision_config
                f, grid, span, secs = self._video_features(
                    r["video"], r.get("sampling_fps", 1), r.get("max_frames", 1),
                    r.get("total_pixels", 3 * 28 * 28))
                vision_s.append(secs)
                texts += [vt2m_prompt(span, c) for c in (T2M_NEGATIVE_CAPTION, r["caption"])]
                feats += [f, f]
                grids += [grid, grid]
                spgts += [vcfg.temporal_patch_size / r.get("fps", 1)] * 2

        ids, mask = self._tokenize(texts)
        flat_codec = np.concatenate(codec_rows, axis=0) if codec_rows else None
        vision_kw = {}
        if grids:
            from .models.model import get_rope_index

            visual_embeds, visual_mask = self._scatter_video(ids, feats)
            position_ids, deltas = get_rope_index(
                ids, cfg, video_grid_thw=np.stack(grids), second_per_grid_ts=spgts,
                attention_mask=mask)
            vision_kw = dict(visual_embeds=visual_embeds, visual_mask=visual_mask,
                             prefill_position_ids=position_ids, rope_deltas=deltas)
        paths = self._generate_core(
            ids, mask, flat_codec, save_name, None, output_dir,
            np.asarray(p_cfg, np.float32), np.asarray(p_temp, np.float32),
            np.asarray(p_topp, np.float32), 45, np.asarray(p_eosf, np.float32), do_sample, seed,
            max_tokens=max(p_max), min_tokens=np.asarray(p_min, np.int32),
            max_tokens_vec=np.asarray(p_max, np.int32), sample_seeds=np.asarray(p_seed, np.int64),
            **vision_kw)
        self.last_timings["vision_s"] = vision_s
        return paths


def create_unimoe_audio(model_path: str, device_id: int = 0) -> UniMoEAudio:
    """Convenience constructor (`api.py:1224`)."""
    return UniMoEAudio(model_path, device_id)
