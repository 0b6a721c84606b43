"""Chunked streaming generation: audio yielded while decoding continues —
counterpart of `unimoe_audio_tpu/generate/streaming.py`.

The decode loop pauses every `chunk_frames` steps (`generate`'s `stop_at`
and resumable loop state, one KV cache for the whole stream), the delay
pattern is reverted over the frames that are final (a frame is final once
`max_delay` further steps exist), and each chunk's codes, and its waveform
when a Dac is given, are yielded.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from ..codec import delay as dl
from ..config import UniMoEAudioConfig
from .loop import generate, pad_buffer


def generate_stream(
    params: Dict,
    cfg: UniMoEAudioConfig,
    input_ids,                       # [2B, T_text] CFG-interleaved, numpy or tensor
    attention_mask,
    codec_input_ids,                 # [2B, T_text, C] aligned, or None
    gen: torch.Generator,
    *,
    max_tokens: int,
    min_tokens: int,
    chunk_frames: int = 25,
    cfg_scale: float = 10.0,
    temperature: float = 1.0,
    top_p: float = 1.0,
    cfg_filter_top_k: int = 45,
    eos_prob_mul_factor: float = 0.6,
    do_sample: bool = True,
    dac=None,
    kv_dtype: str = None,
) -> Iterator[Dict]:
    """Yields one dict per chunk, on the device of `gen`:
      {"frames": np [B, n_new, C] delay-reverted codes (0 past a stream's end),
       "audio":  np [B, n_new·hop] waveform (when a Dac is given),
       "lengths": np [B] frames of each stream so far,
       "done":   bool}
    Incremental lengths mean most for one prompt: per-sample EOS can end
    the streams of a batch at different steps."""
    dev = gen.device
    B = input_ids.shape[0] // 2
    C = cfg.codec_channels
    max_delay = cfg.max_delay
    prefill, prefill_steps = dl.prepare_audio_prompt(
        [None] * B, num_channels=C, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    buf = pad_buffer(torch.as_tensor(prefill, device=dev), max_tokens)
    ids = torch.as_tensor(np.asarray(input_ids), device=dev)
    mask = torch.as_tensor(np.asarray(attention_mask), device=dev)
    kwargs = dict(max_tokens=max_tokens, min_tokens=min_tokens, cfg_scale=cfg_scale,
                  temperature=temperature, top_p=top_p, cfg_filter_top_k=cfg_filter_top_k,
                  eos_prob_mul_factor=eos_prob_mul_factor, do_sample=do_sample,
                  return_state=True, kv_dtype=kv_dtype)

    state = None
    emitted = 0                                  # frames already yielded (audio domain)
    start = min(prefill_steps) - 1
    stop = start + chunk_frames
    while True:
        res, state = generate(params, cfg, ids, mask, codec_input_ids, buf, prefill_steps, gen,
                              state, stop, **kwargs)
        done = bool((state.eos_countdown == 0).all()) or state.dec_step >= max_tokens
        # The EOS machine may still rewrite the last max_delay steps, so
        # they are held back until done; at done the stream is trimmed to
        # its audio length (the countdown's steps carry EOS / PAD).
        produced = state.dec_step - start
        lengths = res.lengths.cpu().numpy()
        safe = int(lengths.max()) if done else max(0, produced - max_delay)
        if safe > emitted:
            codes = res.codes.cpu().numpy()      # [B, max_tokens, C], PAD past each span
            lo, hi = emitted, min(safe + max_delay, max_tokens)
            reverted = dl.revert_audio_delay(codes[:, lo:hi], pad_value=cfg.codec_pad_value,
                                             delay_pattern=cfg.codec_delay_pattern)
            reverted = reverted[:, :safe - emitted]
            frame_idx = np.arange(lo, lo + reverted.shape[1])
            reverted = np.where(frame_idx[None, :, None] >= lengths[:, None, None], 0, reverted)
            out = {"frames": reverted, "done": done,
                   "lengths": np.minimum(lengths, lo + reverted.shape[1])}
            if dac is not None:
                out["audio"] = np.stack([
                    dac.decode_array(np.clip(reverted[b], 0, cfg.codec_eos_value - 1).T[None])[0]
                    for b in range(B)])
            emitted = safe
            yield out
        elif done:
            yield {"frames": np.zeros((B, 0, C), np.int32), "done": True}
        if done:
            return
        stop += chunk_frames
