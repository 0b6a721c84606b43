"""The port's program spans and counters (`unimoe_audio_torch/utils/profiling.py`)
on the CPU: nothing is recorded without a profiler; under one, a tiny
`SlotServer` records its steps, admissions, prefills, decode steps with
their stop reads, attention and DCMoE blocks, the DCMoE counters equal the
block's own expert mask, and a tiny `Trainer.fit` records each step's five
phases.  Served codes and trained parameters are bit-equal with recording
on and off."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.torch_threads import one_torch_thread  # noqa: F401
from unimoe_audio_torch.apps import continuous as TC
from unimoe_audio_torch.codec import delay as dl
from unimoe_audio_torch.config import tiny_test_config
from unimoe_audio_torch.models.model import init_model_params
from unimoe_audio_torch.moe.block import dcmoe_block
from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig
from unimoe_audio_torch.utils import profiling

T_TEXT = 8


def _recording():
    return profile(activities=[ProfilerActivity.CPU])


def _window(fn):
    """fn() under a CPU profiler; (its result, what was recorded meanwhile)."""
    t0 = time.time_ns()
    with _recording():
        out = fn()
    return out, profiling.recorded(t0, time.time_ns())


def _names(rec, name):
    return [i for i, s in enumerate(rec["spans"]) if s.name == name]


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_test_config()
    return cfg, init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu")


def _request(cfg, seed, max_tokens):
    rng = np.random.default_rng(seed)
    tl = T_TEXT - seed % 3
    ids = np.zeros((2, T_TEXT), np.int32)
    mask = np.zeros((2, T_TEXT), np.int32)
    ids[:, :tl] = rng.integers(1, cfg.text_config.vocab_size - 1, size=(2, tl))
    mask[:, :tl] = 1
    prefill, steps = dl.prepare_audio_prompt(
        [None], num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    return TC.SlotRequest(input_ids=ids, attention_mask=mask, prefill=np.asarray(prefill[0]),
                          prefill_steps=int(steps[0]), max_tokens=max_tokens, min_tokens=2,
                          cfg_scale=3.0, seed=seed, rid=f"req{seed}")


def _serve(cfg, params, steps_out=None):
    """Three requests through a two-slot server, greedy, chunks of 4: the
    third is admitted when a slot frees.  steps_out collects the decode
    steps of each chunk."""
    server = TC.SlotServer(params, cfg, slots=2, t_text=T_TEXT, horizon=48, chunk_frames=4,
                           do_sample=False)
    for seed, budget in ((1, 9), (2, 14), (3, 10)):
        server.submit(_request(cfg, seed, budget))
    calls = 0
    while server.queue or server.active.any():
        before = server._dec_h
        server.step()
        calls += 1
        if steps_out is not None:
            steps_out.append(server._dec_h - before)
    return {r.rid: (r.codes, r.length) for r in server.results}, calls


def test_nothing_recorded_without_a_profiler(tiny):
    cfg, params = tiny
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.span("a") is profiling.span("b", rid=1, device=True)
    t0 = time.time_ns()
    with profiling.span("x"):
        profiling.count("c", 3)
        profiling.count("c", torch.ones(4, dtype=torch.int32))
    _serve(cfg, params)
    rec = profiling.recorded(t0, time.time_ns())
    assert rec["spans"] == [] and rec["counters"].get("c", 0) == 0


def test_recorded_window_nesting_and_counters():
    t0 = time.time_ns()
    with _recording():
        with profiling.span("outer", rid="r1"):
            with profiling.span("inner"):
                profiling.count("n", 2)
                profiling.count("n", torch.tensor([[1, 0], [1, 1]], dtype=torch.int32))
            with profiling.span("inner"):
                pass
        with profiling.span("cpu.device", device=True):
            pass
    t1 = time.time_ns()
    rec = profiling.recorded(t0, t1)
    names = [s.name for s in rec["spans"]]
    assert names == ["outer", "inner", "inner", "cpu.device"]
    outer, a, b, dev = rec["spans"]
    assert outer.parent is None and outer.rid == "r1"
    assert a.parent == 0 and b.parent == 0 and a.rid is None
    assert outer.t0_ns <= a.t0_ns <= a.t1_ns <= b.t0_ns <= b.t1_ns <= outer.t1_ns
    assert dev.device_ms is None                    # no CUDA events on the CPU
    assert rec["counters"]["n"] == 5
    # A window after the block holds neither its spans nor its counts.
    later = profiling.recorded(t1, time.time_ns())
    assert later["spans"] == [] and later["counters"]["n"] == 0


def test_slot_server_spans_and_codes_unchanged(tiny):
    cfg, params = tiny
    want, _ = _serve(cfg, params)
    chunk_steps = []
    (got, calls), rec = _window(lambda: _serve(cfg, params, chunk_steps))
    for rid, (codes, length) in want.items():
        assert np.array_equal(got[rid][0], codes) and got[rid][1] == length, rid
    spans = rec["spans"]
    steps = _names(rec, "slot.step")
    assert len(steps) == calls
    admits = _names(rec, "slot.admit")
    assert sorted(spans[i].rid for i in admits) == ["req1", "req2", "req3"]
    assert all(spans[spans[i].parent].name == "slot.step" for i in admits)
    prefills = _names(rec, "generate.prefill")
    assert len(prefills) == 3
    assert sorted(spans[spans[i].parent].rid for i in prefills) == ["req1", "req2", "req3"]
    assert all(spans[spans[i].parent].name == "slot.admit" for i in prefills)

    decode = _names(rec, "generate.decode_step")
    assert len(decode) == sum(chunk_steps) > 0
    for i in decode:
        assert spans[spans[i].parent].name == "slot.step"
        kids = [s.name for s in spans if s.parent == i]
        assert kids.count("generate.stop_read") == 1
    L = cfg.text_config.num_hidden_layers
    forwards = len(decode) + len(prefills)
    assert len(_names(rec, "moe.block")) == L * forwards
    assert len(_names(rec, "model.attention")) == L * forwards
    assert len(_names(rec, "slot.retire")) == sum(1 for n in chunk_steps if n > 0)
    assert rec["counters"]["moe.routed_tokens"] == L * (len(decode) * 2 * 2 + 3 * 2 * T_TEXT)


@pytest.mark.parametrize("dispatch_mode", ["dense", "packed"])
def test_routed_expert_counter_equals_the_expert_mask(tiny, dispatch_mode):
    cfg, params = tiny
    tc = cfg.text_config
    x = torch.randn(2, 5, tc.hidden_size, generator=torch.Generator().manual_seed(4))
    pad = torch.tensor([[1, 1, 1, 1, 0], [0, 1, 1, 1, 1]])
    out, rec = _window(lambda: dcmoe_block(params["layers"][0]["moe"], x, tc,
                                           padding_token_mask=pad, dispatch_mode=dispatch_mode))
    real = int(out.expert_mask[:, :tc.mlp_dynamic_expert_num].sum())
    assert real > 0
    assert rec["counters"]["moe.routed_experts"] == real
    assert rec["counters"]["moe.routed_tokens"] == 10
    assert len(_names(rec, "moe.block")) == 1


def _batch(cfg, seed, B=2, T=12):
    rng = np.random.default_rng(seed)
    codec = rng.integers(0, cfg.codec_eos_value, size=(B, T, cfg.codec_channels)).astype(np.int32)
    return {"input_ids": np.full((B, T), cfg.codec_placeholder_value, np.int32),
            "codec_input_ids": codec, "attention_mask": np.ones((B, T), np.int32),
            "codec_labels": codec}


def _fit(cfg, params):
    tcfg = TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=8, log_every=1,
                         save_every=0, remat=True)
    tr = Trainer(cfg, params, tcfg, device="cpu")
    tr.fit([_batch(cfg, 30 + i) for i in range(2)])
    return [t.detach().clone() for t in _leaves(tr.state.params)]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_trainer_fit_phases_and_parameters_unchanged():
    cfg = tiny_test_config(input_jitter_noise=0.0)

    def fresh():
        return init_model_params(cfg, seed=1, dtype=torch.float32, device="cpu")

    want = _fit(cfg, fresh())
    got, rec = _window(lambda: _fit(cfg, fresh()))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    spans = rec["spans"]
    steps = _names(rec, "train.step")
    assert len(steps) == 2
    for i in steps:
        kids = [s.name for s in spans if s.parent == i]
        assert kids == ["train.place", "train.forward", "train.backward", "train.optimizer",
                        "train.log"]
    assert len(_names(rec, "train.fetch")) == 3       # two batches and the end
    # Remat's recompute opens the layers' spans inside the backward too.
    L = cfg.text_config.num_hidden_layers
    assert len(_names(rec, "moe.block")) == 2 * 2 * L
