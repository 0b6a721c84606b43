"""Rolling-serving driver: the port's continuous slot server
(`apps/continuous.SlotServer`) fed text-to-music requests made by
`UniMoEAudio.make_slot_request`, every retired request decoded to a
waveform by `UniMoEAudio.decode_slot_results`, in a closed loop whose
backlog never empties.

Traffic parameters (the mix's file):
  slots, t_text, chunk_frames      the server's shape;
  caption_words [lo, hi]           words per caption;
  budget_frames [lo, hi]           clip budgets of the backlog's requests;
  fill_frames [lo, hi]             budgets of the fill admitted at set-up,
                                   which stands for requests in flight;
  cycle                            requests per cycle of the backlog: each
                                   cycle holds the same budgets and caption
                                   lengths (evenly spaced over the ranges),
                                   in an order drawn from the seed, so every
                                   seed brings the same work;
  greedy_every                     every n-th request decodes greedily (the
                                   check compares greedy tokens), the others
                                   sample at temperature 1;
  cfg_scale, warmup_chunks, check_requests.
A request's minimum length is its budget, so that random weights do not
end a clip early.

Set-up: the weights from the seed (`harness/weights.py`), handed to
`UniMoEAudio` (which quantizes them as the configuration's serving mode
says), the DAC's from the seed, the server, the fill, and `warmup_chunks`
chunks.  The window runs chunks until `seconds` have passed and ends at a
chunk's end; `audio_rtf` counts the audio frames every slot produced in
it (a request's progress is its decoded audio frames), over 50 frames a
second, over the window.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time
import zlib
from typing import Dict, List

import numpy as np
import torch

from harness import core, model_config, tokenizer, weights

FRAME_RATE = 50


class Requests:
    """The mix's requests in order, from the seed."""

    def __init__(self, model, traffic: Dict, seed: int):
        self.model, self.t, self.seed = model, traffic, seed
        self.made: Dict[int, object] = {}
        self.n = 0

    def _cycle_value(self, key: str, idx: int, n: int, lo_hi) -> float:
        lo, hi = lo_hi
        perm = np.random.default_rng([self.seed, zlib.crc32(key.encode()), idx // n]).permutation(n)
        return lo + (hi - lo) * perm[idx % n] / max(n - 1, 1)

    def make(self, budget: int, words: int):
        i = self.n
        self.n += 1
        rng = np.random.default_rng([self.seed, 7, i])
        caption = " ".join(f"w{x}" for x in rng.integers(0, 10 ** 6, size=words))
        greedy = i % self.t["greedy_every"] == 0
        req = self.model.make_slot_request(
            "text_to_music", caption=caption, seed=int(rng.integers(0, 2 ** 31)),
            max_audio_seconds=(budget + 0.5) / FRAME_RATE,
            min_audio_seconds=(budget + 0.5) / FRAME_RATE,
            cfg_scale=self.t["cfg_scale"], temperature=1.0, top_p=0.0 if greedy else 1.0,
            rid=i)
        self.made[i] = (req, greedy)
        return req

    def fill(self, k: int) -> List:
        n = self.t["slots"]
        return [self.make(round(self._cycle_value("fill", j, n, self.t["fill_frames"])),
                          round(self._cycle_value("fwords", j, n, self.t["caption_words"])))
                for j in range(k)]

    def backlog(self, k: int) -> List:
        n = self.t["cycle"]
        out = []
        for _ in range(k):
            j = self.n - self.t["slots"]
            out.append(self.make(
                round(self._cycle_value("budget", j, n, self.t["budget_frames"])),
                round(self._cycle_value("words", j, n, self.t["caption_words"]))))
        return out


def progress(server) -> Dict[object, int]:
    """Audio frames decoded so far by each active slot's request."""
    st = server.state
    fin = st.finished_step.cpu().numpy()
    out = {}
    for s in range(server.S):
        if server.active[s]:
            end = st.dec_step + 1 if fin[s] < 0 else int(fin[s])
            out[server.rids[s]] = max(0, end - int(server.ps[s]))
    return out


def make_model(r: core.Run, cfg):
    from unimoe_audio_torch.api import SPECIAL_TOKENS, UniMoEAudio
    from unimoe_audio_torch.codec.dac import init_dac_params

    params = weights.make_params(cfg, r.seed, r.device)
    serving = r.config["serving"]

    class Served(UniMoEAudio):
        """The API with the benchmark's weights in place of a checkpoint."""

        def _load_model(self, model_path, *, dtype, allow_random, config):
            nonlocal params
            given, params = params, None
            return config, given

    model = Served(config=cfg, allow_random=True, device=r.device,
                   tokenizer=tokenizer.for_model(cfg, SPECIAL_TOKENS),
                   serving_mode=serving["serving_mode"],
                   kv_cache_dtype=serving["kv_cache_dtype"], a8_compute=serving["a8_compute"])
    if model.dac is not None:
        model.dac.params = init_dac_params(model.dac.config, seed=weights.kind_seed(r.seed, "norm")
                                           + 1, device=r.device)
    return model


def run(r: core.Run) -> None:
    from unimoe_audio_torch.apps.continuous import SlotServer
    from unimoe_audio_torch.moe import dispatch

    cfg = model_config.build(r.config)
    t = r.traffic
    serving = r.config["serving"]
    dev = r.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    model = make_model(r, cfg)
    S = t["slots"]
    server = SlotServer(
        model.params, cfg, slots=S, t_text=t["t_text"],
        horizon=model.MAX_TOKENS + 512 + 4 * t["chunk_frames"], chunk_frames=t["chunk_frames"],
        do_sample=True, kv_dtype=serving["kv_cache_dtype"],
        decode_dispatch_mode=serving["decode_dispatch_mode"],
        decode_capacity=serving["decode_capacity_per_row"] * 2 * S)
    reqs = Requests(model, t, r.seed)
    out_dir = tempfile.mkdtemp(prefix="portbench-wav-")
    retired: Dict[object, object] = {}
    admissions: List = []          # each admitted request's attention mask, in order

    def submit(batch):
        for q in batch:
            server.submit(q)

    def chunk() -> None:
        """One server step with the harness's bookkeeping: the queue topped
        up to a full set of slots, the retired requests decoded."""
        with r.span("refill"):
            if len(server.queue) < S:
                submit(reqs.backlog(S - len(server.queue)))
        free = [s for s in range(S) if not server.active[s]]
        queued = [q.rid for q in server.queue[:len(free)]]
        with r.span("step"):
            results = server.step()
        done = {x.rid for x in results}
        admissions.extend(reqs.made[rid][0].attention_mask for rid in queued
                          if rid in server.rids or rid in done)
        if results:
            with r.span("decode_slot_results"):
                model.decode_slot_results(results, out_dir)
        for x in results:
            retired[x.rid] = x

    try:
        submit(reqs.fill(S))
        for _ in range(t["warmup_chunks"]):
            chunk()
        sync()
        r.e2e["setup_s"] = core.process_age_s()

        admissions.clear()
        before = set(retired)
        p0 = progress(server)
        occupancy: List[float] = []
        steps = 0
        calls0 = dispatch.int8_expert_matmul.calls
        with core.DeviceTrace(r.trace) as tr:
            t0 = time.perf_counter()
            while time.perf_counter() < t0 + r.seconds:
                occupancy.append(float(np.mean(server.active)))
                busy = bool(server.active.any()) or bool(server.queue)
                chunk()
                steps += t["chunk_frames"] if busy else 0
            sync()
            t1 = time.perf_counter()
        p1 = progress(server)
        in_window = [rid for rid in retired if rid not in before]
        frames = (sum(retired[rid].length - p0.get(rid, 0) for rid in in_window)
                  + sum(v - p0.get(rid, 0) for rid, v in p1.items()))
        r.e2e["audio_rtf"] = frames / FRAME_RATE / (t1 - t0)
        r.attempted = len(in_window)
        r.memory_peak_bytes = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
        r.layer.update(
            cfg=cfg, window_s=t1 - t0, steps=steps, rows=2 * S, occupancy=occupancy,
            int8_calls=dispatch.int8_expert_matmul.calls - calls0,
            admissions=list(admissions), t_text=t["t_text"],
            mean_progress=float(np.mean(list(p1.values()) or [0])))
        r.layer["window_ns"] = (tr.t0, tr.t1)
        if r.trace:
            t_red = time.perf_counter()
            r.layer["trace"] = core.reduce_trace(tr, r.spans)
            r.phases.update(trace_stop_s=tr.stop_s, trace_read_s=tr.read_s,
                            trace_reduce_s=time.perf_counter() - t_red)

        # The check: greedy requests finished in the window, the longest
        # among them, the rest drawn from the seed.
        greedy = [rid for rid in in_window if reqs.made[rid][1]]
        greedy.sort(key=lambda rid: -retired[rid].length)
        rng = np.random.default_rng([r.seed, 11])
        rest = list(rng.permutation(greedy[1:]))[:max(t["check_requests"] - 1, 0)]
        sample = greedy[:1] + [int(x) for x in rest]
        cases = [(reqs.made[rid][0], retired[rid]) for rid in sample]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    del server, model, reqs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    from reference import serve_check

    t_ref = time.perf_counter()
    serve_check.compare(r, cfg, cases, stats_out=r.layer)
    r.phases.update(window_s=r.layer["window_s"], reference_s=time.perf_counter() - t_ref)
