"""Self-speculative greedy decoding for single-stream latency — counterpart
of `unimoe_audio_tpu/generate/speculative.py`.

A draft made of the first `draft_layers` layers of the same model (plus the
final norm and the codec head: no extra weights) proposes `spec_len - 1`
frames one at a time; one forward of the full model over the `spec_len`
frames of the chunk verifies them.  Greedy acceptance keeps the output
equal to the baseline greedy decode with the same attention arithmetic,
`generate(do_sample=False, decode_emit=False)`: the verify forward takes
the general cache path, which is what that baseline's decode steps take.

Scope: one stream (its two CFG rows), greedy.  The prefill takes the
baseline loop's route (K1 at T_text >= 128 on the card).

Cache discipline: the draft steps write the k/v of layers [0, draft_layers)
into the LIVE cache, in place, through the emit path (the JAX package
writes them into a copy it then discards).  The verify forward writes every
layer's k/v at all `spec_len` positions of the chunk before it attends, so
no draft write is ever read: an accepted position holds the verify's k/v,
a rejected one lies beyond the validity mask until a later verify
overwrites it.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import UniMoEAudioConfig
from ..models.model import codec_embedding, codec_logits_from_hidden, text_model_forward
from .loop import _sync, generate, guided_logits


class SpecResult(NamedTuple):
    codes: torch.Tensor      # [1, max_tokens, C] delayed-domain codes
    lengths: torch.Tensor    # [1]
    frames: int              # frames decoded
    cycles: int              # verify cycles run
    accept_rate: float       # accepted drafts per cycle / (spec_len - 1)


def greedy_frames(cfg: UniMoEAudioConfig, logits: torch.Tensor, steps: torch.Tensor,
                  min_tokens: torch.Tensor, cfg_scale: torch.Tensor,
                  eos_mul: torch.Tensor) -> torch.Tensor:
    """The decode loop's CFG combine and EOS gating, then argmax, for frame
    positions (`speculative.py:57-78`).  logits [2, n, C, Vc] (the CFG
    pair), steps [n] the decode steps that decide them → [n, C] int32."""
    return guided_logits(cfg, logits[0], logits[1], steps >= min_tokens, cfg_scale,
                         eos_mul).argmax(dim=-1).to(torch.int32)


@torch.inference_mode()
def speculative_generate(
    params: Dict,
    cfg: UniMoEAudioConfig,
    input_ids: torch.Tensor,          # [2, T_text] CFG pair
    attention_mask: torch.Tensor,     # [2, T_text]
    codec_input_ids: Optional[torch.Tensor],
    prefill_buf: torch.Tensor,        # [1, buf_len, C]
    prefill_steps,                    # [1] host ints
    *,
    max_tokens: int,
    min_tokens: int,
    cfg_scale: float,
    eos_prob_mul_factor: float,
    spec_len: int = 4,
    draft_layers: int = 8,
    dispatch_mode: str = "dense",
    decode_capacity: Optional[int] = None,
    prefill_capacity: Optional[int] = None,
    kv_dtype: Optional[str] = None,
    timings: Optional[Dict[str, float]] = None,
) -> SpecResult:
    """Greedy speculative decode (`speculative_generate_jit`,
    `speculative.py:92-326`), equal to `generate(do_sample=False,
    decode_emit=False)` up to the order of floating-point reductions.
    The cache holds T_text + max_tokens + spec_len + 2 slots.  Each cycle
    makes one host-to-device copy (the buffer rows of the chunk) and one
    device-to-host read (the proposals and the targets); the commit runs on
    the host.  With a `timings` dict the device is synchronised around the
    prefill and the decode and their seconds land in "prefill_s" /
    "decode_s"."""
    tc = cfg.text_config
    dev = input_ids.device
    B2, T_text = input_ids.shape
    assert B2 == 2, "speculative decode serves one stream (one CFG pair)"
    C = cfg.codec_channels
    eos, pad = cfg.codec_eos_value, cfg.codec_pad_value
    delay = np.asarray(cfg.codec_delay_pattern, np.int64)
    max_delay = cfg.max_delay
    d = spec_len
    T_total = T_text + max_tokens + d + 2
    ps = int(np.asarray(prefill_steps).reshape(-1)[0])
    min_t = torch.tensor(min_tokens, dtype=torch.int64, device=dev)
    scale_t = torch.tensor(cfg_scale, dtype=torch.float32, device=dev)
    eos_mul_t = torch.tensor(eos_prob_mul_factor, dtype=torch.float32, device=dev)

    # The prefill is the baseline loop's own (K1 at T_text >= 128 on the
    # card), stopped before its first decode step.
    start_step = ps - 1
    pre: Optional[Dict[str, float]] = None if timings is None else {}
    _, state = generate(
        params, cfg, input_ids, attention_mask, codec_input_ids, prefill_buf, [ps], None,
        stop_at=start_step, cache_len=T_total, return_state=True, max_tokens=max_tokens,
        min_tokens=min_tokens, cfg_scale=cfg_scale, temperature=1.0, top_p=1.0,
        cfg_filter_top_k=None, eos_prob_mul_factor=eos_prob_mul_factor, do_sample=False,
        timings=pre, dispatch_mode=dispatch_mode, kv_dtype=kv_dtype,
        prefill_capacity=prefill_capacity)
    cache = state.cache
    if timings is not None:
        timings["prefill_s"] = timings.get("prefill_s", 0.0) + pre["prefill_s"]
        t1 = time.perf_counter()

    draft_params = {**params, "layers": params["layers"][:draft_layers]}
    key_idx = torch.arange(T_total, device=dev)[None, :]
    text_valid = torch.nn.functional.pad(attention_mask.to(torch.int32), (0, T_total - T_text))

    def kv_valid_for(cache_pos_last: int) -> torch.Tensor:
        return torch.where(key_idx < T_text, text_valid,
                           (key_idx <= cache_pos_last).to(torch.int32))

    def positions(rel0: int, n: int) -> torch.Tensor:
        rel = torch.arange(rel0, rel0 + n, device=dev)
        return (state.pos_base[:, None] + rel[None, :])[None].expand(3, 2, n)

    buf = prefill_buf[0].cpu().numpy().astype(np.int64)             # host buffer [buf_len, C]
    buf_len = buf.shape[0]
    dec, eos_det, eos_cd, fin = start_step, False, -1, -1
    cycles = accepted = 0
    while dec < max_tokens and eos_cd != 0:
        t = dec
        rel0 = t - start_step
        # The buffer rows of frames t+1 .. t+d (prompt / BOS slots >= 0 win
        # the merge); rows past the buffer are open and never committed.
        rows = np.full((d, C), -1, np.int64)
        n_in = max(0, min(d, buf_len - t - 1))
        rows[:n_in] = buf[t + 1:t + 1 + n_in]
        rows_t = torch.as_tensor(rows, device=dev)
        chunk = torch.empty((d, C), dtype=torch.int64, device=dev)
        chunk[0] = torch.as_tensor(buf[t], device=dev)

        # Draft: frames t+1 .. t+d-1 from the first draft_layers layers,
        # their k/v written into the live cache (overwritten by the verify).
        for i in range(d - 1):
            emb = codec_embedding(params, chunk[i][None, None].expand(2, 1, C))
            out = text_model_forward(
                draft_params, emb, positions(rel0 + i, 1), tc, kv_cache=cache,
                cache_position=T_text + rel0 + i, kv_valid_mask=kv_valid_for(T_text + rel0 + i),
                dispatch_mode=dispatch_mode, capacity=decode_capacity)
            logits = codec_logits_from_hidden(params, out.last_hidden_state, cfg)   # [2, 1, C, Vc]
            frame = greedy_frames(cfg, logits, torch.tensor([t + i], device=dev), min_t,
                                  scale_t, eos_mul_t)[0]
            chunk[i + 1] = torch.where(rows_t[i] == -1, frame.to(torch.int64), rows_t[i])

        # Verify: one full forward over the chunk, the general cache path.
        emb = codec_embedding(params, chunk[None].expand(2, d, C))
        out = text_model_forward(
            params, emb, positions(rel0, d), tc, kv_cache=cache, cache_position=T_text + rel0,
            kv_valid_mask=kv_valid_for(T_text + rel0 + d - 1), dispatch_mode=dispatch_mode,
            capacity=decode_capacity, decode_emit=False)
        logits = codec_logits_from_hidden(params, out.last_hidden_state, cfg)       # [2, d, C, Vc]
        raw = greedy_frames(cfg, logits, torch.arange(t, t + d, device=dev), min_t, scale_t,
                            eos_mul_t).to(torch.int64)
        host = torch.cat([chunk, raw]).cpu().numpy()                # the cycle's one read
        chunk_h, raw_h = host[:d], host[d:]
        targets = np.where(rows == -1, raw_h, rows)                # MERGED: acceptance
        agree = np.all(chunk_h[1:] == targets[:-1], axis=-1)
        n_acc = int(np.argmin(np.concatenate([agree, [False]])))  # in [0, d-1]

        # Commit frames t+1 .. t+n_acc+1 through the delay-pattern EOS
        # machine, from the RAW targets; a commit that departs from what
        # the chunk embedded blocks the rest (`speculative.py:244-296`).
        for i in range(n_acc + 1):
            step_no = t + i + 1
            if step_no >= buf_len:
                break
            pred = raw_h[i].copy()
            trigger = eos_cd != 0 and ((not eos_det and pred[0] == eos)
                                       or step_no >= max_tokens - max_delay)
            eos_det = eos_det or trigger
            if trigger and eos_cd < 0:
                eos_cd, fin = max_delay, step_no
            padding = eos_cd > 0
            if padding:
                step_after = max_delay - eos_cd
                pred = np.where(step_after == delay, eos, np.where(step_after > delay, pad, pred))
                eos_cd -= 1
            merged = np.where(buf[step_no] == -1, pred, buf[step_no])
            buf[step_no] = merged
            dec = step_no
            if padding or np.any(merged != targets[i]):
                break
        cycles += 1
        accepted += n_acc
    if timings is not None:
        _sync(dev)
        timings["decode_s"] = timings.get("decode_s", 0.0) + time.perf_counter() - t1

    finished = dec + 1 - max_delay if fin == -1 else fin
    length = int(np.clip(finished - ps, 0, max_tokens))
    codes = np.full((max_tokens, C), pad, np.int64)
    window = buf[ps:ps + max_tokens]
    span = min(length + max_delay, window.shape[0])
    codes[:span] = np.where(window[:span] == -1, pad, window[:span])
    return SpecResult(
        codes=torch.as_tensor(codes[None], dtype=torch.int32, device=dev),
        lengths=torch.tensor([length], dtype=torch.int32, device=dev),
        frames=dec - start_step, cycles=cycles,
        accept_rate=accepted / max(cycles * (d - 1), 1))
