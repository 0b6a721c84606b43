"""Training driver: the port's `Trainer.fit` on batches of codec rows.

Traffic parameters (the mix's file): `batch` B, `seq_len` T.  Each batch is
the layout of the fine-tuning probe: every position a codec placeholder,
codec ids drawn from (seed, step) over [0, eos), the labels the same ids.

Set-up makes the weights on the device from the seed, builds one
`Trainer`, and drives it through its first three steps by `fit`, the call
and the feed the window uses; the window then runs `fit` over batches
until `seconds` have passed.  Between set-up steps the check records, for
each leaf, the first moment after step 1 (the first gradient as the
optimizer takes it; a copy on the host, and its norm) and, after step 3, the norm of the change from
the starting weights (made again from the seed, kind by kind); that
bookkeeping is left out of `setup_s`.  Once the window has closed and the
program is freed, the reference (`reference/train_check.py`) follows the
same three steps.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import core, model_config, weights


def batch_at(cfg, seed: int, step: int, B: int, T: int) -> dict:
    C = cfg.codec_channels
    codec = np.random.default_rng([seed, step]).integers(
        0, cfg.codec_eos_value, size=(B, T, C), dtype=np.int32)
    return {"input_ids": np.full((B, T), cfg.codec_placeholder_value, np.int32),
            "codec_input_ids": codec, "attention_mask": np.ones((B, T), np.int32),
            "codec_labels": codec}


def trainer_config(conf: dict, seed: int):
    from unimoe_audio_torch.train.trainer import TrainerConfig

    t = conf["trainer"]
    return TrainerConfig(learning_rate=t["learning_rate"], warmup_steps=t["warmup_steps"],
                         total_steps=t["total_steps"], weight_decay=t["weight_decay"],
                         grad_clip=t["grad_clip"], remat=t["remat"],
                         dispatch_mode=t["dispatch_mode"], log_every=1, save_every=0,
                         seed=seed)


def leaf_norms(tensors) -> dict:
    return {weights.leaf_name(p): float(torch.linalg.vector_norm(t.detach().float()))
            for p, t in tensors}


def change_norms(cfg, seed: int, params, device) -> dict:
    """Per leaf ||p - p0||, p0 made again from the seed one kind at a time."""
    paths = [(p, t) for p, t in weights.walk(params)]
    out = {}
    for kind in weights.kinds_in([p for p, _ in paths]):
        stack = weights.make_kind(cfg, seed, kind, device)
        for p, t in paths:
            if weights.leaf_kind(p)[0] == kind:
                p0 = weights.leaf_from_kinds(p, {kind: stack})
                out[weights.leaf_name(p)] = float(torch.linalg.vector_norm(
                    t.detach().float() - p0.float()))
        del stack
    return out


def run(r: core.Run) -> None:
    from unimoe_audio_torch.train.trainer import Trainer

    cfg = model_config.build(r.config)
    B, T = r.traffic["batch"], r.traffic["seq_len"]
    dev = r.device
    params = weights.make_params(cfg, r.seed, dev)
    trainer = Trainer(cfg, params, trainer_config(r.config, r.seed), device=dev)
    del params
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    record: dict = {"losses": [], "mean_top_k": []}
    step_no = 0

    def feed(n_max: int, until=None, stamps=None):
        nonlocal step_no
        for _ in range(n_max):
            if until is not None and time.perf_counter() >= until:
                return
            if stamps is not None:
                stamps.append(time.perf_counter())
            b = batch_at(cfg, r.seed, step_no, B, T)
            step_no += 1
            yield b

    def fit(batches):
        hist = trainer.fit(batches)
        for h in hist:
            record["losses"].append(h["loss"])
            record["mean_top_k"].append(h["mean_top_k"])
            r.failed += int(h["skipped"])
        r.attempted += len(hist)
        return hist

    # Set-up: three steps through fit, with the check's bookkeeping.
    fit(feed(1))
    t = time.perf_counter()
    state = trainer.state
    paths = [p for p, _ in weights.walk(state.params)]
    record["m1"] = leaf_norms(zip(paths, state.opt_state.mu))
    # The first moments themselves, for the reference's leaves (the
    # embedding table and the text head, which the codec rows never reach,
    # stay behind).
    record["m1_t"] = {weights.leaf_name(p): m.detach().to("cpu", copy=True)
                      for p, m in zip(paths, state.opt_state.mu)
                      if p[0] not in ("embed_tokens", "lm_head")}
    r.setup_deduct_s += time.perf_counter() - t
    fit(feed(2))
    sync()
    t = time.perf_counter()
    record["d3"] = change_norms(cfg, r.seed, state.params, dev)
    sync()
    r.setup_deduct_s += time.perf_counter() - t
    r.e2e["setup_s"] = core.process_age_s() - r.setup_deduct_s

    # The window.
    setup_peak = 0
    if dev.type == "cuda":
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    stamps: list = []
    n0 = len(record["losses"])
    with core.DeviceTrace(r.trace) as tr:
        t0 = time.perf_counter()
        with r.span("fit"):
            fit(feed(10 ** 9, until=t0 + r.seconds, stamps=stamps))
        sync()
        t1 = time.perf_counter()
    n = len(record["losses"]) - n0
    stamps.append(t1)
    r.e2e["train_tokens_per_s"] = n * B * T / (t1 - t0)
    if dev.type == "cuda":
        r.layer["peak_bytes_window"] = torch.cuda.max_memory_allocated()
        r.memory_peak_bytes = max(setup_peak, r.layer["peak_bytes_window"])
    r.layer.update(
        cfg=cfg, B=B, T=T, window_s=t1 - t0, steps=n,
        step_s=list(np.diff(stamps)), mean_top_k=record["mean_top_k"][n0:])
    r.layer["window_ns"] = (tr.t0, tr.t1)
    if r.trace:
        t_red = time.perf_counter()
        r.layer["trace"] = core.reduce_trace(tr, r.spans)
        r.phases.update(trace_stop_s=tr.stop_s, trace_read_s=tr.read_s,
                        trace_reduce_s=time.perf_counter() - t_red)
    losses3 = record["losses"][:3]

    # Free the program, then the reference.
    del trainer, state
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    from reference import train_check

    t_ref = time.perf_counter()
    ref = train_check.follow(cfg, r.config, r.seed, dev, batch_at, B, T)
    r.phases.update(window_s=t1 - t0, reference_s=time.perf_counter() - t_ref)
    r.layer["real_share"] = ref["real"] / ref["top_k"]
    train_check.compare(r, losses3, record["m1"], record["d3"], ref, record["m1_t"])
