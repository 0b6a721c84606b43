"""Continuous (rolling) batching for the decode loop — counterpart of
`unimoe_audio_tpu/apps/continuous.py`: request slots, admission,
retirement and cache compaction at chunk boundaries.

The request batcher (`apps/batcher.py`) decodes each batch to its end, so a
finished stream's slot idles until the batch drains and arrivals wait for
the next window.  This server keeps ONE live decode state with a fixed
number of request slots (two CFG rows each) and, every `chunk_frames`
decode steps:

  * RETIRES finished rows (their delay-pattern countdown reached 0) and
    returns their codes;
  * ADMITS queued requests into free slots: a standalone prefill of the
    request (its text KV cache, delayed prompt buffer and per-sample knobs)
    is spliced into the live state in place;
  * COMPACTS the KV cache when the decode region nears its horizon: the
    dead prefix that no active row attends (below every active row's
    decode start) is rolled out along the time axis.

It rests on the loop's serving hooks (`generate/loop.generate`):
`decode_start` masks an admitted row's unwritten cache gap, `start_step`
pins the global step origin as rows churn, `seed_step_offset` keeps each
request's counter-based sampling chain row-relative, and `rope_deltas`
keeps its positions row-relative.

Parity: a GREEDY request decoded through the server gives the codes of the
same request decoded alone, up to the order of floating-point reductions
(an admitted row's keys sit at other cache slots, with a masked gap).
Sampled requests draw from the same per-request chain; under
capacity-packed dispatch co-resident rows can take each other's expert
slots, so only dense dispatch keeps a request independent of the others.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import UniMoEAudioConfig
from ..generate.loop import LoopState, generate
from ..models.layers import KVCache
from ..parallel.mesh import kv_heads


@dataclasses.dataclass
class SlotRequest:
    """One tensor-level request, built as `api._generate_core` builds its
    CFG pairs (`UniMoEAudio.make_slot_request`)."""

    input_ids: np.ndarray        # [2, T_req] CFG pair [neg, cond]
    attention_mask: np.ndarray   # [2, T_req]
    prefill: np.ndarray          # [P, C] delayed prompt buffer (-1 = open)
    prefill_steps: int
    max_tokens: int
    min_tokens: int = 0
    cfg_scale: float = 10.0
    temperature: float = 1.0
    top_p: float = 1.0
    eos_prob_mul_factor: float = 0.6
    seed: int = 0
    rid: Optional[object] = None  # the caller's request id
    # Voice-clone prompts: flat [N, C] codec rows for the text's N
    # placeholder slots (the contract of `api.text_to_speech`).
    codec_flat: Optional[np.ndarray] = None
    # VT2M: the tower's features at the video slots and the mRoPE inputs
    # (`api.video_text_to_music`); visual_embeds may be a device tensor.
    visual_embeds: Optional[object] = None             # [2, T_req, D]
    visual_mask: Optional[np.ndarray] = None           # [2, T_req]
    prefill_position_ids: Optional[np.ndarray] = None  # [3, 2, T_req]
    rope_deltas: Optional[np.ndarray] = None           # [2]


@dataclasses.dataclass
class SlotResult:
    rid: object
    codes: np.ndarray   # [max_tokens, C] delayed-domain codes (PAD past the end),
                        # as a row of GenerateResult.codes
    length: int
    wait_s: float = 0.0   # submit → admission (queueing)
    serve_s: float = 0.0  # admission → retirement (decode residency)


class SlotServer:
    """Fixed-slot continuous-batching decode server.

    All shapes are fixed: `slots` requests x `t_text` text tokens x a
    `horizon`-frame decode region.  `horizon` covers the longest request
    budget plus admission slack; compaction reclaims space as requests
    retire, so the server runs indefinitely.  The cache is time-major
    [L, t_text + horizon + 2, 2 x slots, KV, Dh] (int8 with scales
    [L, T, 2 x slots, KV] for kv_dtype="int8") on the params' device, and
    every update to it is made in place.
    """

    def __init__(self, params: Dict, cfg: UniMoEAudioConfig, *, slots: int = 4,
                 t_text: int = 32, horizon: int = 512, chunk_frames: int = 64,
                 do_sample: bool = True, dispatch_mode: str = "dense",
                 decode_dispatch_mode: Optional[str] = None,
                 decode_capacity: Optional[int] = None,
                 prefill_capacity: Optional[int] = None, kv_dtype: Optional[str] = None):
        self.params, self.cfg = params, cfg
        self.kv_dtype = kv_dtype
        self.S, self.T = slots, t_text
        self.C = cfg.codec_channels
        self.H_frames = horizon
        self.chunk = chunk_frames
        self.buf_len = horizon + 2
        self.cache_len = t_text + horizon + 2
        self.do_sample = do_sample
        self.dispatch = dict(dispatch_mode=dispatch_mode,
                             decode_dispatch_mode=decode_dispatch_mode,
                             decode_capacity=decode_capacity, prefill_capacity=prefill_capacity)
        S, T, C = slots, t_text, cfg.codec_channels
        tc = cfg.text_config
        dev = self.device = params["embed_tokens"].device

        # Parked rows: one attendable text token (all-invalid keys would
        # NaN the softmax), the buffer all PAD so that writes never
        # surface, countdown 0 so that they never extend the loop.
        self.input_ids = np.zeros((2 * S, T), np.int32)
        self.attention_mask = np.zeros((2 * S, T), np.int32)
        self.attention_mask[:, 0] = 1
        self.ps = np.zeros((S,), np.int32)            # per-row prefill_steps
        self.min_vec = np.zeros((S,), np.int32)
        self.mt_vec = np.full((S,), 1, np.int32)
        self.cfg_vec = np.zeros((S,), np.float32)
        self.temp_vec = np.ones((S,), np.float32)
        self.topp_vec = np.ones((S,), np.float32)
        self.eosf_vec = np.ones((S,), np.float32)
        self.seeds = np.zeros((S,), np.int64)
        self.d_start = np.full((S,), T, np.int32)     # first valid decode slot
        self.seed_off = np.zeros((S,), np.int32)
        # Per-row mRoPE decode base as a delta against T: text rows
        # attended_len - T, vision rows get_rope_index's delta.  The loop's
        # base is T + (base_delta - the row's admission offset).
        self.base_delta = np.zeros((2 * S,), np.int32) + 1 - T
        self.active = np.zeros((S,), bool)
        self.rids: List[object] = [None] * S
        self.req_max = np.zeros((S,), np.int32)

        self.state = LoopState(
            dec_step=0,
            buf=torch.full((S, self.buf_len, C), cfg.codec_pad_value, dtype=torch.int32,
                           device=dev),
            cache=KVCache.create(tc.num_hidden_layers, 2 * S, self.cache_len,
                                 kv_heads(params, tc), tc.head_dim, device=dev,
                                 dtype=torch.int8 if kv_dtype == "int8"
                                 else params["embed_tokens"].dtype),
            eos_detected=torch.zeros((S,), dtype=torch.bool, device=dev),
            eos_countdown=torch.zeros((S,), dtype=torch.int32, device=dev),
            finished_step=torch.full((S,), -1, dtype=torch.int32, device=dev),
            guidance_loss=torch.zeros((), dtype=torch.float32, device=dev),
            guidance_count=torch.zeros((), dtype=torch.int32, device=dev),
            pos_base=torch.zeros((2 * S,), dtype=torch.int32, device=dev),
        )
        self.queue: List[SlotRequest] = []
        self.results: List[SlotResult] = []
        self.compactions = 0
        self._submit_t: Dict[int, float] = {}
        self._admit_t = np.zeros((S,), np.float64)
        self._wait_s = np.zeros((S,), np.float64)
        # Host mirrors of the loop-control state, refreshed by ONE
        # device-to-host read per chunk; _splice, cancel and _compact apply
        # the same updates on both sides.
        self._dec_h = 0
        self._cd_h = np.zeros((S,), np.int32)
        self._fin_h = np.full((S,), -1, np.int32)

    # -- request intake ---------------------------------------------------
    def submit(self, req: SlotRequest) -> None:
        need = req.prefill.shape[0] + req.max_tokens + self.cfg.max_delay + 2
        if need > self.buf_len:
            raise ValueError(f"request needs {need} frames; horizon is {self.H_frames}")
        if req.max_tokens < req.prefill_steps + self.cfg.max_delay + 1:
            # max_tokens counts decode steps from step 0 (the prompt's
            # included), so a budget inside prompt + max_delay cannot hold
            # the EOS staircase: alone the request would stop mid-staircase,
            # here it would finish it.
            raise ValueError(
                f"max_tokens={req.max_tokens} < prefill_steps ({req.prefill_steps}) + "
                f"max_delay ({self.cfg.max_delay}) + 1; raise the budget")
        if req.input_ids.shape[1] > self.T:
            raise ValueError(f"request text {req.input_ids.shape[1]} > t_text {self.T}")
        self._submit_t[id(req)] = time.time()
        self.queue.append(req)

    def cancel(self, rid) -> bool:
        """Drop a request by rid: from the queue while it waits, or by
        freeing its live slot (the row stops extending the loop and its
        writes never surface).  True if something was cancelled."""
        for i, q in enumerate(self.queue):
            if q.rid == rid:
                self._submit_t.pop(id(q), None)
                del self.queue[i]
                return True
        for slot in range(self.S):
            if self.active[slot] and self.rids[slot] == rid:
                self.active[slot] = False
                self.rids[slot] = None
                self.state.buf[slot] = self.cfg.codec_pad_value
                self.state.eos_countdown[slot] = 0
                self.state.eos_detected[slot] = True
                self._cd_h[slot] = 0
                return True
        return False

    # -- admission --------------------------------------------------------
    def _prefill_request(self, req: SlotRequest):
        """The request's standalone prefill at the server's t_text: returns
        its KV cache [L, cache_len, 2, KV, Dh] (the decode region zero,
        masked by decode_start until written), its mask and ids.  At
        t_text >= 128 on the card the prefill takes K1 (the loop's gate)."""
        T, C, dev = self.T, self.C, self.device
        ids = np.zeros((2, T), np.int32)
        mask = np.zeros((2, T), np.int32)
        t_req = req.input_ids.shape[1]
        ids[:, :t_req] = req.input_ids
        mask[:, :t_req] = req.attention_mask
        aligned = None
        if req.codec_flat is not None:
            from ..models.model import align_codec_ids

            flat = np.tile(np.asarray(req.codec_flat), (2, 1))          # both CFG rows
            aligned = torch.as_tensor(
                align_codec_ids(ids, flat, self.cfg.codec_placeholder_value), device=dev)
        vision = {}
        if req.visual_embeds is not None:
            feats = torch.as_tensor(req.visual_embeds, device=dev)
            ve = torch.zeros((2, T, feats.shape[-1]), dtype=feats.dtype, device=dev)
            ve[:, :t_req] = feats
            vm = np.zeros((2, T), np.int32)
            vm[:, :t_req] = req.visual_mask
            vision.update(visual_embeds=ve, visual_mask=torch.as_tensor(vm, device=dev))
        if req.prefill_position_ids is not None:
            ppos = np.zeros((3, 2, T), np.int64)
            ppos[:, :, :t_req] = req.prefill_position_ids
            vision["prefill_position_ids"] = torch.as_tensor(ppos, device=dev)
        buf1 = torch.full((1, self.buf_len, C), -1, dtype=torch.int32, device=dev)
        buf1[0, :req.prefill.shape[0]] = torch.as_tensor(req.prefill, device=dev)
        _, st = generate(
            self.params, self.cfg, torch.as_tensor(ids, device=dev),
            torch.as_tensor(mask, device=dev), aligned, buf1, [req.prefill_steps], None,
            stop_at=0, cache_len=self.cache_len, return_state=True, max_tokens=1,
            min_tokens=0, cfg_scale=req.cfg_scale, temperature=1.0, top_p=1.0,
            cfg_filter_top_k=45, eos_prob_mul_factor=1.0, do_sample=False,
            dispatch_mode=self.dispatch["dispatch_mode"],
            prefill_capacity=self.dispatch["prefill_capacity"], kv_dtype=self.kv_dtype,
            **vision)
        return st.cache, mask, ids

    def _splice(self, slot: int, cache2: KVCache, buf_row: np.ndarray) -> None:
        """The request's cache into rows 2·slot, 2·slot + 1 of the live
        cache (scales included), its buffer row into the live buffer, and
        its loop-control state reset; all in place."""
        st, r = self.state, slice(2 * slot, 2 * slot + 2)
        st.cache.k[:, :, r] = cache2.k
        st.cache.v[:, :, r] = cache2.v
        if st.cache.quantized:
            st.cache.k_scale[:, :, r] = cache2.k_scale
            st.cache.v_scale[:, :, r] = cache2.v_scale
        st.buf[slot] = torch.as_tensor(buf_row, device=self.device)
        st.eos_detected[slot] = False
        st.eos_countdown[slot] = -1
        st.finished_step[slot] = -1
        self._cd_h[slot] = -1
        self._fin_h[slot] = -1

    def _admit(self) -> None:
        d0 = self._dec_h
        for slot in range(self.S):
            if self.active[slot] or not self.queue:
                continue
            req = self.queue.pop(0)
            P = req.prefill.shape[0]
            if d0 + req.max_tokens + P + self.cfg.max_delay + 2 > self.buf_len:
                # Not enough horizon left: wait for a compaction.
                self.queue.insert(0, req)
                break
            cache2, mask, ids = self._prefill_request(req)
            # Alone, the loop's first read is buf[ps - 1] (start_step =
            # ps - 1); here the next read is buf[d0], so the row's content
            # shifts by delta = d0 + 1 - ps.  Frames below ps - 1 are never
            # read; the delayed tail past ps (later channels' prompt
            # content) rides along and wins its merges as it would alone.
            delta = d0 + 1 - req.prefill_steps
            row = np.full((self.buf_len, self.C), -1, np.int32)
            row[:d0] = self.cfg.codec_pad_value                       # never read again
            src0 = req.prefill_steps - 1
            n_copy = min(P - src0, self.buf_len - d0)
            row[d0:d0 + n_copy] = req.prefill[src0:src0 + n_copy]
            self._splice(slot, cache2, row)
            self.input_ids[2 * slot:2 * slot + 2] = ids
            self.attention_mask[2 * slot:2 * slot + 2] = mask
            self.base_delta[2 * slot:2 * slot + 2] = (
                np.asarray(req.rope_deltas).reshape(-1) if req.rope_deltas is not None
                else mask.sum(-1) - self.T)
            self.ps[slot] = d0 + 1                                     # = ps + delta
            self.min_vec[slot] = req.min_tokens + delta
            self.mt_vec[slot] = req.max_tokens + delta
            self.cfg_vec[slot] = req.cfg_scale
            self.temp_vec[slot] = req.temperature
            self.topp_vec[slot] = req.top_p
            self.eosf_vec[slot] = req.eos_prob_mul_factor
            self.seeds[slot] = req.seed
            self.d_start[slot] = self.T + d0
            self.seed_off[slot] = delta
            self.req_max[slot] = req.max_tokens
            self.active[slot] = True
            self.rids[slot] = req.rid
            now = time.time()
            self._admit_t[slot] = now
            self._wait_s[slot] = now - self._submit_t.pop(id(req), now)

    # -- retirement -------------------------------------------------------
    def _retire(self) -> None:
        buf = None
        for slot in range(self.S):
            if not self.active[slot] or self._cd_h[slot] != 0:
                continue
            if buf is None:
                buf = self.state.buf.cpu().numpy()
            ps, mt = int(self.ps[slot]), int(self.req_max[slot])
            length = int(np.clip(self._fin_h[slot] - ps, 0, mt))
            codes = np.full((mt, self.C), self.cfg.codec_pad_value, np.int32)
            span = min(length + self.cfg.max_delay, mt)
            window = buf[slot, ps:ps + span]
            codes[:span] = np.where(window == -1, self.cfg.codec_pad_value, window)
            self.results.append(SlotResult(
                rid=self.rids[slot], codes=codes, length=length,
                wait_s=round(float(self._wait_s[slot]), 3),
                serve_s=round(time.time() - float(self._admit_t[slot]), 3)))
            self.active[slot] = False
            self.rids[slot] = None
            # Claim the row's buffer until the next admission overwrites it.
            self.state.buf[slot] = self.cfg.codec_pad_value

    # -- compaction -------------------------------------------------------
    def _compact(self) -> None:
        """Drop the dead decode prefix [T, T + m): the slots below every
        active row's decode_start hold only retired rows' k/v.  The decode
        region of the cache (k, v and their scales) and the buffer roll
        left by m in place; their tails are cleared."""
        m = self._dec_h if not self.active.any() else int(self.d_start[self.active].min()) - self.T
        if m <= 0:
            return
        st, T = self.state, self.T
        for x in ((st.cache.k, st.cache.v, st.cache.k_scale, st.cache.v_scale)
                  if st.cache.quantized else (st.cache.k, st.cache.v)):
            n = x.shape[1]
            x[:, T:n - m] = x[:, T + m:].clone()
            x[:, n - m:] = 0
        n = st.buf.shape[1]
        st.buf[:, :n - m] = st.buf[:, m:].clone()
        st.buf[:, n - m:] = -1
        st.dec_step -= m
        # finished_step is an absolute step: rows caught mid-staircase
        # shift with the origin.
        st.finished_step = torch.where(st.finished_step >= 0, st.finished_step - m,
                                       st.finished_step)
        self.compactions += 1
        # Every step-indexed quantity is relative to the global origin,
        # which just moved left by m (inactive rows' values go stale and
        # are rewritten at their next admission).
        for v in (self.ps, self.min_vec, self.mt_vec, self.seed_off):
            v -= m
        self.d_start = np.maximum(self.d_start - m, self.T)
        self._dec_h -= m
        self._fin_h = np.where(self._fin_h >= 0, self._fin_h - m, self._fin_h).astype(np.int32)

    # -- the chunk loop ---------------------------------------------------
    def step(self) -> List[SlotResult]:
        """One chunk: compact if needed, admit, decode `chunk_frames`
        steps, retire.  Returns the results completed in this chunk."""
        if self._dec_h + self.chunk + 2 >= self.H_frames or (self.queue and not self.active.all()):
            self._compact()
        self._admit()
        n_before = len(self.results)
        if self.active.any():
            dev = self.device
            # The loop's decode base is T + rd; subtracting each row's
            # admission offset (d_start - T) keeps positions row-relative.
            rd = self.base_delta - (self.d_start.repeat(2) - self.T)
            _, st = generate(
                self.params, self.cfg, torch.as_tensor(self.input_ids, device=dev),
                torch.as_tensor(self.attention_mask, device=dev), None, self.state.buf,
                self.ps, None, resume_state=self.state, stop_at=self._dec_h + self.chunk,
                start_step=0, decode_start=self.d_start, seed_step_offset=self.seed_off,
                rope_deltas=torch.as_tensor(rd.astype(np.int32), device=dev),
                cache_len=self.cache_len, return_state=True, max_tokens=self.H_frames,
                min_tokens=self.min_vec, cfg_scale=self.cfg_vec, temperature=self.temp_vec,
                top_p=self.topp_vec, cfg_filter_top_k=45, eos_prob_mul_factor=self.eosf_vec,
                max_tokens_vec=self.mt_vec, sample_seeds=self.seeds, do_sample=self.do_sample,
                **{k: v for k, v in self.dispatch.items() if v is not None})
            self.state = st
            # ONE device-to-host read refreshes the countdown and
            # finished-step mirrors (dec_step is a host int).
            ctl = torch.cat([st.eos_countdown, st.finished_step]).cpu().numpy()
            self._dec_h = int(st.dec_step)
            self._cd_h = ctl[:self.S].astype(np.int32)
            self._fin_h = ctl[self.S:].astype(np.int32)
            self._retire()
        return self.results[n_before:]

    def run_until_drained(self, max_chunks: int = 10_000) -> List[SlotResult]:
        """step() until the queue and every slot are empty."""
        for _ in range(max_chunks):
            if not self.queue and not self.active.any():
                break
            self.step()
        out, self.results = self.results, []
        return out
