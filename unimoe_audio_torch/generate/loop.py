"""Autoregressive codec-frame generation — counterpart of
`unimoe_audio_tpu/generate/loop.py` (`generate_jit` → `generate`,
`generate_chunked`, `decode_position_base`, `pad_buffer`).

Prefill, then a Python decode loop over a preallocated KV cache, with CFG
pairs batched as interleaved rows [neg, cond] × B and the delay-pattern EOS
countdown as loop state.  The loop's stop test reads the countdown on the
host, one device sync per step.  The decode step is one function of the
state and of the call's device inputs (the step counter among them, a 0-d
tensor); on the card it is captured once as a CUDA graph and replayed
where `decode_graph.eligible` holds, and runs eagerly elsewhere.  With
guidance labels each step also adds the teacher-forced cross-entropy of
its logits (the reference's "golden loss"), and `debug_guidance_step` can
force the labels in as predictions.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import UniMoEAudioConfig
from ..models.layers import KVCache, local_kv_start, quantize_kv
from ..parallel.mesh import kv_heads
from ..models.model import (
    calculate_input_embedding,
    codec_embedding,
    codec_logits_from_hidden,
    text_model_forward,
)
from ..utils import profiling
from . import decode_graph
from .sampler import row_keys, sample_next_token

# A decode graph is captured only where the call has at least this many
# steps left (the capture's own and one replay): a capture costs about one
# eager step of host time, and each replay saves nearly one.
_MIN_GRAPH_STEPS = 2


class GenerateResult(NamedTuple):
    codes: torch.Tensor     # [B, max_tokens, C] delayed-domain codes from each prefill step
    lengths: torch.Tensor   # [B] audio frame counts (pre-delay-revert)
    steps: int              # decode steps executed
    guidance_loss: torch.Tensor   # mean teacher-forced CE over the valid labels; 0 without
    guidance_count: torch.Tensor  # valid labels counted into it


@dataclass
class LoopState:
    dec_step: int
    buf: torch.Tensor            # [B, buf_len, C] int32
    cache: KVCache
    eos_detected: torch.Tensor   # [B] bool
    eos_countdown: torch.Tensor  # [B] int32
    finished_step: torch.Tensor  # [B] int32
    guidance_loss: torch.Tensor  # f32 sum of the weighted NLL so far
    guidance_count: torch.Tensor  # int32 valid labels so far
    pos_base: torch.Tensor       # [2B] mRoPE position of decode step 0
    graph: Optional["decode_graph.DecodeGraph"] = None   # the decode step's CUDA graph


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _per_sample(x, B: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(x).reshape(-1), (B,))


def generate(
    params: Dict,
    cfg: UniMoEAudioConfig,
    input_ids: torch.Tensor,         # [2B, T_text] CFG-interleaved [neg, cond]
    attention_mask: torch.Tensor,    # [2B, T_text]
    codec_input_ids: Optional[torch.Tensor],  # [2B, T_text, C] aligned, or None
    prefill_buf: torch.Tensor,       # [B, buf_len, C] delayed prefill, -1 = open
    prefill_steps,                   # [B] host ints
    gen: torch.Generator,
    resume_state: Optional[LoopState] = None,
    stop_at: Optional[int] = None,
    *,
    max_tokens: int,
    min_tokens,                      # host scalar or [B]
    cfg_scale,
    temperature,
    top_p,
    cfg_filter_top_k: Optional[int],
    eos_prob_mul_factor,
    cache_len: Optional[int] = None,
    return_state: bool = False,
    do_sample: bool = True,
    timings: Optional[Dict[str, float]] = None,
    dispatch_mode: str = "dense",
    decode_dispatch_mode: Optional[str] = None,
    decode_capacity: Optional[int] = None,
    prefill_capacity: Optional[int] = None,
    kv_dtype: Optional[str] = None,
    guidance_labels: Optional[torch.Tensor] = None,
    debug_guidance_step: int = 0,
    decode_emit: Optional[bool] = None,
    visual_embeds: Optional[torch.Tensor] = None,         # [2B, T_text, D]
    visual_mask: Optional[torch.Tensor] = None,           # [2B, T_text], 1 = vision slot
    prefill_position_ids: Optional[torch.Tensor] = None,  # [3, 2B, T_text] mRoPE
    rope_deltas: Optional[torch.Tensor] = None,           # [2B] or [2B, 1]
    max_tokens_vec=None,                                  # [B] per-sample budgets
    sample_seeds=None,                                    # [B] per-sample seeds
    decode_start=None,                                    # [B] first valid decode slot
    start_step: Optional[int] = None,
    seed_step_offset=None,                                # [B]
    prefix_kv=None,                                       # ([L, n, KV, Dh], same)
):
    """Prefill + decode loop (`generate_jit`, `loop.py:66-453`).  Resumes
    from `resume_state` (skipping the prefill) and pauses at `stop_at`, so
    `generate_chunked` can grow the cache between chunks.  With a `timings`
    dict the device is synchronised around the prefill and the decode and
    their seconds are added to "prefill_s" / "decode_s".  `dispatch_mode`
    runs the DCMoE blocks of the prefill, and of the decode steps unless
    `decode_dispatch_mode` is given; the capacities go to the packed path of
    each phase.  kv_dtype="int8" keeps the KV cache in int8 with
    per-(position, head) scales (`models/layers.KVCache`).

    guidance_labels [B, buf_len, C] (delayed-domain labels, < 0 = none):
    each step adds the cross-entropy of its gated CFG logits against the
    labels at the step it writes, channel 0 weighted 3x and allowed EOS as a
    target, the other channels not (`loop.py:353-371`); the result's
    guidance_loss is the mean over the valid labels.  debug_guidance_step
    forces the labels in as the predictions of the steps before it (-1: of
    every step).  decode_emit=False runs the decode steps through the
    general cache arithmetic (`models/model.text_model_forward`).

    Vision inputs (`loop.py:178-190`) shape the prefill only: visual_embeds
    replace the embeddings where visual_mask is set (cast to the
    embedding's dtype), prefill_position_ids replace the 1-D text
    positions, and decode starts each row at T_text + rope_deltas
    (`decode_position_base`).  A resumed call takes all of that from the
    state, except that rope_deltas, when given, reset the decode position
    base (as the JAX loop recomputes it on every call).

    Serving hooks (`loop.py:84-114`), each defaulting to one batch decoded
    to its end: max_tokens_vec [B] gives each sample its own budget (its
    EOS countdown starts at max_tokens_vec - max_delay); sample_seeds [B]
    draws each sample from its own counter-based chain keyed by (seed,
    step - seed_step_offset, channel), so that a seeded request samples
    the same codes whichever requests share its batch (dense dispatch;
    the numbers differ from JAX's fold_in chains, the distribution does
    not); decode_start [B] masks cache slots below it for the sample's
    decode steps (a row admitted into a running batch has an unwritten
    gap there); start_step overrides min(prefill_steps) - 1 as the decode
    origin.

    prefix_kv (prefix tuning, `train/peft.prefix_kv`): the learned keys and
    values go into cache slots [0, n) of every row, in the cache's dtype
    (quantized on write into an int8 cache), always attendable; the prompt
    takes slots [n, n + T_text) and every position shifts by n.  The
    prefill then runs at cache_position n, through the cache arithmetic,
    not flash: the fresh window would miss the prefix (`loop.py:136-142,
    195-243`)."""
    tc = cfg.text_config
    dev = input_ids.device
    B2, T_text = input_ids.shape
    B = B2 // 2
    C = cfg.codec_channels
    Vc = cfg.codec_embed_size
    eos, pad = cfg.codec_eos_value, cfg.codec_pad_value
    delay = torch.tensor(cfg.codec_delay_pattern, dtype=torch.int32, device=dev)
    max_delay = cfg.max_delay
    n_pre = 0 if prefix_kv is None else prefix_kv[0].shape[1]
    T_total = cache_len if cache_len is not None else n_pre + T_text + max_tokens + 2
    steps_np = np.asarray(prefill_steps, dtype=np.int64).reshape(-1)
    prefill_steps_t = torch.as_tensor(steps_np, device=dev)

    min_tokens_t = torch.as_tensor(_per_sample(min_tokens, B).astype(np.int32), device=dev)
    cfg_scale_t = torch.as_tensor(_per_sample(cfg_scale, B).astype(np.float32), device=dev)
    eos_mul_t = torch.as_tensor(_per_sample(eos_prob_mul_factor, B).astype(np.float32), device=dev)
    temp_rows = np.repeat(_per_sample(temperature, B).astype(np.float32), C)
    top_p_rows = np.repeat(_per_sample(top_p, B).astype(np.float32), C)
    attention_mask = attention_mask.to(torch.int32)

    start_step = int(steps_np.min()) - 1 if start_step is None else int(start_step)
    mt_vec = torch.as_tensor(
        _per_sample(max_tokens if max_tokens_vec is None else max_tokens_vec, B).astype(np.int64),
        device=dev)
    dstart_2B = None if decode_start is None else torch.as_tensor(
        np.repeat(_per_sample(decode_start, B).astype(np.int64), 2), device=dev)[:, None]
    seeds_t = None if sample_seeds is None else torch.as_tensor(
        _per_sample(sample_seeds, B).astype(np.int64), device=dev)
    seed_off_t = torch.as_tensor(
        _per_sample(0 if seed_step_offset is None else seed_step_offset, B).astype(np.int64),
        device=dev)
    if resume_state is None:
        if timings is not None:
            _sync(dev)
            t0 = time.perf_counter()
        with profiling.span("generate.prefill"):
            inputs_embeds = calculate_input_embedding(
                params, input_ids, codec_input_ids, cfg.codec_placeholder_value)
            if visual_embeds is not None:
                inputs_embeds = torch.where(visual_mask[..., None] > 0,
                                            visual_embeds.to(inputs_embeds.dtype), inputs_embeds)
            if prefill_position_ids is not None:
                position_ids = prefill_position_ids
            else:
                pos = torch.cumsum(attention_mask, dim=-1) - 1
                pos = torch.where(attention_mask == 0, torch.ones_like(pos), pos)
                position_ids = pos[None].expand(3, B2, T_text)
            KV = kv_heads(params, tc)
            cache = KVCache.create(tc.num_hidden_layers, B2, T_total, KV, tc.head_dim, device=dev,
                                   dtype=torch.int8 if kv_dtype == "int8" else inputs_embeds.dtype)
            if n_pre:
                k0 = local_kv_start(tc)                     # this rank's heads on a model group
                shape = (tc.num_hidden_layers, n_pre, B2, KV, tc.head_dim)
                pk, pv = (t[:, :, None, k0:k0 + KV].expand(shape) for t in prefix_kv)
                if cache.quantized:
                    (qk, sk), (qv, sv) = quantize_kv(pk), quantize_kv(pv)
                    cache.k[:, :n_pre], cache.v[:, :n_pre] = qk, qv
                    cache.k_scale[:, :n_pre], cache.v_scale[:, :n_pre] = sk, sv
                else:
                    cache.k[:, :n_pre] = pk.to(cache.k.dtype)
                    cache.v[:, :n_pre] = pv.to(cache.v.dtype)
                position_ids = position_ids + n_pre
            kv_valid = torch.cat(
                [torch.ones(B2, n_pre, dtype=torch.int32, device=dev), attention_mask,
                 torch.zeros(B2, T_total - n_pre - T_text, dtype=torch.int32, device=dev)], dim=-1)
            # Without a prefix the prefill writes cache slots [0, T_text), so
            # attending over the fresh window equals attending over the cache:
            # flash is exact there.
            prefill_flash = (T_text >= 128 and n_pre == 0 and input_ids.is_cuda
                             and not tc.has_sliding_layers)
            text_model_forward(
                params, inputs_embeds, position_ids, tc,
                kv_cache=cache, cache_position=n_pre, kv_valid_mask=kv_valid,
                padding_token_mask=attention_mask,
                use_flash=True if prefill_flash else None,
                dispatch_mode=dispatch_mode, capacity=prefill_capacity,
            )
            state = LoopState(
                dec_step=start_step,
                buf=prefill_buf.clone(),
                cache=cache,
                eos_detected=torch.zeros(B, dtype=torch.bool, device=dev),
                eos_countdown=torch.full((B,), -1, dtype=torch.int32, device=dev),
                finished_step=torch.full((B,), -1, dtype=torch.int32, device=dev),
                guidance_loss=torch.zeros((), dtype=torch.float32, device=dev),
                guidance_count=torch.zeros((), dtype=torch.int32, device=dev),
                pos_base=decode_position_base(attention_mask.sum(dim=-1), T_text,
                                              rope_deltas) + n_pre,
            )
        if timings is not None:
            _sync(dev)
            timings["prefill_s"] = timings.get("prefill_s", 0.0) + time.perf_counter() - t0
    else:
        state = resume_state
        assert state.cache.k.shape[1] == T_total, "resume cache length must match cache_len"
        if rope_deltas is not None:
            state.pos_base = decode_position_base(attention_mask.sum(dim=-1), T_text,
                                                  rope_deltas) + n_pre

    if timings is not None:
        _sync(dev)
        t1 = time.perf_counter()
    stop_step = max_tokens if stop_at is None else min(stop_at, max_tokens)
    key_idx = torch.arange(T_total, device=dev)[None, :]
    # Prefix slots are always attendable.
    text_valid = F.pad(attention_mask, (n_pre, T_total - n_pre - T_text), value=1)
    ch = torch.arange(C, device=dev)[None, :, None]
    ch_weight = torch.where(torch.arange(C, device=dev) == 0, 3.0, 1.0)[None, :]   # [1, C]
    full_top_k = bool((top_p_rows >= 1.0).all())          # the sampler's branch, on the host

    s = state
    # The step's per-call inputs, all on the device: the step counter and
    # the call's origin as 0-d tensors, so that no step-varying host value
    # enters a kernel (a CUDA graph of the step replays them).
    x = dict(dec=torch.full((), s.dec_step, dtype=torch.int64, device=dev),
             start=torch.full((), start_step, dtype=torch.int64, device=dev),
             key_idx=key_idx, text_valid=text_valid, pos_base=s.pos_base, delay=delay,
             min_tokens=min_tokens_t, cfg_scale=cfg_scale_t, eos_mul=eos_mul_t,
             max_tokens=mt_vec, seed_off=seed_off_t,
             temperature=torch.as_tensor(temp_rows, device=dev),
             top_p=torch.as_tensor(top_p_rows, device=dev))
    if dstart_2B is not None:
        x["decode_start"] = dstart_2B
    if seeds_t is not None:
        x["seeds"] = seeds_t

    def decode_step(x):
        """One decode step at step x["dec"]: writes the buffer, the KV cache
        and the control tensors of `s` in place and advances x["dec"]."""
        dec = x["dec"]
        current_step = dec + 1
        rel = dec - x["start"]
        cache_pos = rel + (n_pre + T_text)

        tokens = s.buf.index_select(1, dec.view(1))                     # [B, 1, C]
        emb = codec_embedding(params, tokens.repeat_interleave(2, dim=0))   # [2B, 1, D]
        position_ids = (x["pos_base"] + rel)[None, :, None].expand(3, B2, 1)
        decode_ok = x["key_idx"] <= cache_pos
        if "decode_start" in x:
            decode_ok = decode_ok & (x["key_idx"] >= x["decode_start"])
        kv_valid = torch.where(x["key_idx"] < n_pre + T_text, x["text_valid"],
                               decode_ok.to(torch.int32))
        out = text_model_forward(
            params, emb, position_ids, tc,
            kv_cache=s.cache, cache_position=cache_pos, kv_valid_mask=kv_valid,
            dispatch_mode=decode_dispatch_mode or dispatch_mode, capacity=decode_capacity,
            decode_emit=decode_emit,
        )
        # [2B, C, Vc]
        logits = codec_logits_from_hidden(params, out.last_hidden_state, cfg)[:, 0]

        pair = logits.reshape(B, 2, C, Vc)                             # [neg, cond] rows
        logits_B = guided_logits(cfg, pair[:, 0], pair[:, 1], dec >= x["min_tokens"],
                                 x["cfg_scale"], x["eos_mul"])

        flat = logits_B.reshape(B * C, Vc)
        if do_sample:
            keys = (row_keys(x["seeds"], current_step - x["seed_off"], C) if "seeds" in x
                    else None)
            pred = sample_next_token(gen, flat, temperature=x["temperature"], top_p=x["top_p"],
                                     top_k=cfg_filter_top_k, audio_eos_value=eos, keys=keys,
                                     full_top_k=full_top_k)
        else:
            pred = flat.argmax(dim=-1)
        pred = pred.reshape(B, C).to(torch.int32)

        if guidance_labels is not None:
            # Teacher-forced CE against the labels at current_step (eager
            # only: the labels' steps are read on the host).
            lab = guidance_labels.index_select(1, current_step.view(1))[:, 0].to(torch.int64)
            valid = (lab >= 0) & torch.where(ch[:, :, 0] == 0, lab <= eos, lab < eos)
            logp = torch.log_softmax(logits_B, dim=-1)
            nll = -logp.gather(-1, lab.clamp(0, Vc - 1)[..., None])[..., 0]
            nll = torch.where(valid, nll * ch_weight, torch.zeros_like(nll))
            s.guidance_loss = s.guidance_loss + nll.sum()
            s.guidance_count = s.guidance_count + valid.sum(dtype=torch.int32)
            if debug_guidance_step == -1 or s.dec_step < debug_guidance_step:
                pred = torch.where(lab >= 0, lab.to(pred.dtype), pred)

        # Delay-pattern EOS countdown.
        active = s.eos_countdown != 0
        is_eos_tok = ~s.eos_detected & (pred[:, 0] == eos)
        is_max_len = current_step >= x["max_tokens"] - max_delay
        trigger = active & (is_eos_tok | is_max_len)
        eos_detected = s.eos_detected | trigger
        start_cd = trigger & (s.eos_countdown < 0)
        eos_countdown = torch.where(start_cd, torch.full_like(s.eos_countdown, max_delay),
                                    s.eos_countdown)
        finished_step = torch.where(start_cd, current_step.to(torch.int32), s.finished_step)
        padding_phase = eos_countdown > 0
        step_after = (max_delay - eos_countdown)[:, None]
        eos_write = padding_phase[:, None] & (step_after == x["delay"][None, :])
        pad_write = padding_phase[:, None] & (step_after > x["delay"][None, :])
        pred = torch.where(eos_write, torch.full_like(pred, eos),
                           torch.where(pad_write, torch.full_like(pred, pad), pred))
        eos_countdown = torch.where(padding_phase, eos_countdown - 1, eos_countdown)

        # Mask-merge into the buffer: prompt / BOS slots (>= 0) win.
        at = current_step.view(1)
        cur = s.buf.index_select(1, at)
        s.buf.index_copy_(1, at, torch.where(cur == -1, pred[:, None], cur))
        s.eos_detected.copy_(eos_detected)
        s.eos_countdown.copy_(eos_countdown)
        s.finished_step.copy_(finished_step)
        dec.add_(1)

    # A CUDA graph of the step where the conditions for one hold (see
    # `decode_graph.eligible`): the state's graph while its signature
    # holds, else a new one, captured after one eager step of this call
    # and only where the call has steps left to replay it.
    done = s.dec_step >= stop_step or bool((s.eos_countdown == 0).all())
    graph = key = None
    if not done and decode_graph.eligible(dev, decode_emit=decode_emit,
                                          guidance=guidance_labels is not None,
                                          do_sample=do_sample, keyed=seeds_t is not None):
        key = decode_graph.signature(params, s, x, (
            id(cfg), B, T_text, n_pre, T_total, do_sample, full_top_k, cfg_filter_top_k,
            decode_dispatch_mode or dispatch_mode, decode_capacity))
        if s.graph is not None and s.graph.key == key:
            graph = s.graph
            graph.load(x, s)
        else:
            s.graph = None                    # stale: release its memory first
    warm = False
    while not done:
        with profiling.span("generate.decode_step"):
            if (graph is None and key is not None and warm and not profiling.recording()
                    and stop_step - s.dec_step >= _MIN_GRAPH_STEPS):
                graph = s.graph = decode_graph.DecodeGraph(key, x, s)
                graph.capture(decode_step)
            if graph is not None:
                graph.replay()
            else:
                decode_step(x)
                warm = True
            s.dec_step += 1
            with profiling.span("generate.stop_read"):
                done = s.dec_step >= stop_step or bool((s.eos_countdown == 0).all())

    # Length accounting + repack.
    final_step = s.dec_step + 1
    finished = torch.where(s.finished_step == -1,
                           torch.full_like(s.finished_step, final_step - max_delay),
                           s.finished_step)
    lengths = torch.clamp(finished - prefill_steps_t, 0, max_tokens)
    # Each sample's window from its prefill step; the start is clamped so
    # that the window fits the buffer, as JAX's dynamic_slice clamps it.
    first = prefill_steps_t.clamp(0, max(s.buf.shape[1] - max_tokens, 0))
    idx = first[:, None] + torch.arange(max_tokens, device=dev)[None, :]
    codes = torch.gather(s.buf, 1, idx[:, :, None].expand(B, max_tokens, C))
    span = (lengths + max_delay)[:, None]
    keep = torch.arange(max_tokens, device=dev)[None, :] < span
    codes = torch.where(keep[..., None], codes, torch.full_like(codes, pad))
    codes = torch.where(codes == -1, torch.full_like(codes, pad), codes)
    result = GenerateResult(
        codes=codes, lengths=lengths, steps=s.dec_step - start_step,
        guidance_loss=s.guidance_loss / s.guidance_count.clamp_min(1),
        guidance_count=s.guidance_count)
    if timings is not None:
        _sync(dev)
        timings["decode_s"] = timings.get("decode_s", 0.0) + time.perf_counter() - t1
    return (result, s) if return_state else result


def guided_logits(cfg: UniMoEAudioConfig, uncond: torch.Tensor, cond: torch.Tensor,
                  enable_eos: torch.Tensor, cfg_scale: torch.Tensor,
                  eos_mul: torch.Tensor) -> torch.Tensor:
    """CFG combine and EOS gating of codec logits (`loop.py:306-322`): the
    decode loop's and the speculative verify's.  uncond / cond [N, C, Vc];
    enable_eos (step >= min_tokens), cfg_scale and eos_mul are [N] or
    scalars.  Columns past EOS are never taken, EOS only on channel 0 and
    only once enabled, and channel 0's EOS logit is scaled by eos_mul."""
    def per_row(x):
        return x.reshape(-1, 1, 1)

    eos, dev = cfg.codec_eos_value, cond.device
    col = torch.arange(cfg.codec_embed_size, device=dev)[None, None, :]
    ch = torch.arange(cfg.codec_channels, device=dev)[None, :, None]
    scale = per_row(cfg_scale)
    out = torch.where(scale != 0, cond + scale * (cond - uncond), cond)
    kill = (col > eos) | ((ch > 0) & (col >= eos)) | (~per_row(enable_eos) & (col >= eos))
    out = torch.where(kill, torch.full((), float("-inf"), device=dev), out)
    return torch.where((ch == 0) & (col == eos), out * per_row(eos_mul), out)


def generate_chunked(
    params: Dict,
    cfg: UniMoEAudioConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    codec_input_ids: Optional[torch.Tensor],
    prefill_buf: torch.Tensor,
    prefill_steps,
    gen: torch.Generator,
    *,
    chunk_frames: int = 256,
    **kwargs,
):
    """`generate` with a KV cache that grows across decode chunks
    (`loop.py:456-530`): each chunk of `chunk_frames` steps attends over a
    right-sized cache, grown (one copy) between chunks.  Same result as one
    `generate` call.  The vision inputs (visual_embeds, visual_mask,
    prefill_position_ids, rope_deltas) go to the first chunk only; later
    chunks resume from its state."""
    vision = {k: kwargs.pop(k, None) for k in ("visual_embeds", "visual_mask",
                                               "prefill_position_ids", "rope_deltas")}
    T_text = input_ids.shape[1]
    max_tokens = kwargs.pop("max_tokens")
    return_state = kwargs.pop("return_state", False)
    start = kwargs.get("start_step")
    start = int(np.min(np.asarray(prefill_steps))) - 1 if start is None else int(start)
    pkv = kwargs.get("prefix_kv")
    n_pre = 0 if pkv is None else pkv[0].shape[1]

    def bucket(n_frames: int) -> int:
        return -(-(n_pre + T_text + n_frames + 2) // chunk_frames) * chunk_frames

    state = None
    stop = start + chunk_frames
    while True:
        cache_len = bucket(min(stop - start, max_tokens))
        if state is not None and state.cache.k.shape[1] < cache_len:
            state.cache = state.cache.grow(cache_len)
        res, state = generate(
            params, cfg, input_ids, attention_mask, codec_input_ids, prefill_buf,
            prefill_steps, gen, state, min(stop, max_tokens),
            max_tokens=max_tokens, cache_len=cache_len, return_state=True,
            **(vision if state is None else {}), **kwargs)
        if bool((state.eos_countdown == 0).all()) or state.dec_step >= max_tokens:
            return (res, state) if return_state else res
        stop += chunk_frames


def decode_position_base(text_lens: torch.Tensor, T_text: int,
                         rope_deltas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample mRoPE position of decode step 0: the attended text length,
    or T_text + rope_delta after a vision prefill."""
    if rope_deltas is None:
        return text_lens
    return T_text + rope_deltas.reshape(-1).to(torch.int32)


def pad_buffer(prefill: torch.Tensor, max_tokens: int) -> torch.Tensor:
    """Extend the delayed prefill buffer by max_tokens open (-1) frames."""
    B, P, C = prefill.shape
    fill = torch.full((B, max_tokens, C), -1, dtype=prefill.dtype, device=prefill.device)
    return torch.cat([prefill, fill], dim=1)
