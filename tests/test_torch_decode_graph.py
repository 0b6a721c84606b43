"""The decode step of `generate` written once and either run eagerly or
replayed from a CUDA graph (`unimoe_audio_torch/generate/decode_graph.py`).

On the CPU (the eager path):
  * the decode commit at a 0-d device position equals the commit at a host
    int, for the bf16 and the int8 cache (scales included) and for the
    general cache path;
  * tiny-config `generate` gives, bit for bit, the codes, lengths, buffer
    and control state that the loop gave while its step counter was a host
    int (digests recorded from that loop, f32, one torch thread), greedy
    and counter-keyed, in one call and resumed across `stop_at` chunks;
  * the eligibility rule declines CPU tensors, guidance labels, Generator
    draws, the general cache step and a mesh of several ranks.

On the card (`pytest --noconftest -q -m cuda tests/test_torch_decode_graph.py`):
a tiny int4 `SlotServer` with `packed_a8` decode and an int8 cache, driven
through admissions, a cancellation, retirements and compactions, replays
its steps from one graph and matches, bit for bit, the same server run
eagerly (codes, lengths, buffer, cache and control state after every
chunk), with the same launch and routing counts."""

import hashlib
import time

import numpy as np
import pytest
import torch

from unimoe_audio_torch.codec import delay as dl
from unimoe_audio_torch.config import tiny_test_config
from unimoe_audio_torch.generate import decode_graph, loop
from unimoe_audio_torch.generate.loop import generate, pad_buffer
from unimoe_audio_torch.models.layers import KVCache
from unimoe_audio_torch.models.model import init_model_params, text_model_forward
from tests.torch_threads import one_torch_thread  # noqa: F401

B, T_TEXT, MAX_TOKENS = 2, 8, 24


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_test_config()
    return cfg, init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu")


# ---------------------------------------------------------------------------
# The commit at a device position.

@pytest.mark.parametrize("kv", ["bf16", "int8", "general"])
def test_commit_at_device_position(tiny, kv):
    """One decode step through `text_model_forward` at cache position 11,
    given as a host int and as a 0-d tensor: the same hidden states and
    the same cache, scales included ("general": decode_emit=False, the
    write-then-attend cache path, in bf16)."""
    cfg, params = tiny
    tc = cfg.text_config
    g = torch.Generator().manual_seed(1)
    L, T_kv, B2 = tc.num_hidden_layers, 20, 4
    dtype = torch.int8 if kv == "int8" else torch.bfloat16
    cache = KVCache.create(L, B2, T_kv, tc.num_key_value_heads, tc.head_dim, dtype=dtype,
                           device="cpu")
    for t in (cache.k, cache.v):
        t.copy_(torch.randint(-100, 100, t.shape, generator=g) if kv == "int8"
                else torch.randn(t.shape, generator=g).to(dtype))
    if cache.quantized:
        cache.k_scale.copy_(torch.rand(cache.k_scale.shape, generator=g) * 0.02)
        cache.v_scale.copy_(torch.rand(cache.v_scale.shape, generator=g) * 0.02)
    emb = torch.randn(B2, 1, tc.hidden_size, generator=g)
    pos = torch.full((3, B2, 1), 11)
    valid = (torch.arange(T_kv)[None, :] <= 11).to(torch.int32).expand(B2, T_kv).contiguous()
    outs = []
    for at in (11, torch.tensor(11)):
        c = KVCache(*(None if t is None else t.clone()
                      for t in (cache.k, cache.v, cache.k_scale, cache.v_scale)))
        out = text_model_forward(params, emb, pos, tc, kv_cache=c, cache_position=at,
                                 kv_valid_mask=valid, decode_emit=kv != "general")
        outs.append((out.last_hidden_state, c))
    (h0, c0), (h1, c1) = outs
    assert torch.equal(h0, h1)
    for a, b in ((c0.k, c1.k), (c0.v, c1.v), (c0.k_scale, c1.k_scale), (c0.v_scale, c1.v_scale)):
        assert (a is None and b is None) or torch.equal(a, b)
    assert not torch.equal(c0.k, cache.k)                  # the step did write


# ---------------------------------------------------------------------------
# generate, bit for bit as before.

CASES = {
    "greedy": dict(do_sample=False),
    "keyed_full": dict(do_sample=True, sample_seeds=[11, 12], top_p=1.0),
    "keyed_nucleus": dict(do_sample=True, sample_seeds=[21, 22], top_p=[0.0, 0.8],
                          temperature=[1.0, 0.7]),
    "greedy_int8": dict(do_sample=False, kv_dtype="int8"),
    "greedy_eos": dict(do_sample=False, eos_prob_mul_factor=20.0, min_tokens=[3, 7]),
    "keyed_eos": dict(do_sample=True, sample_seeds=[3, 4], eos_prob_mul_factor=20.0,
                      min_tokens=[5, 2]),
    "keyed_hooks": dict(do_sample=True, sample_seeds=[5, 6], top_p=0.9, max_tokens_vec=[20, 14],
                        seed_step_offset=[0, 1], min_tokens=[3, 9]),
}

# (digest, steps, lengths) of each case, recorded from the loop whose step
# counter was a host int; the same whether decoded in one call or resumed.
BEFORE = {
    "greedy": ("a48971c2a7a5fee6", 23, [18, 18]),
    "keyed_full": ("738d54a7e4377d60", 23, [18, 18]),
    "keyed_nucleus": ("dea1cf1520df0efd", 23, [18, 18]),
    "greedy_int8": ("f0f578b730b379b8", 23, [18, 18]),
    "greedy_eos": ("77f45090c4aa013f", 12, [3, 7]),
    "keyed_eos": ("ff5150ec8598299b", 23, [5, 18]),
    "keyed_hooks": ("f4d7c6daad6c4d74", 19, [14, 8]),
}


def _inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    ids = np.zeros((2 * B, T_TEXT), np.int32)
    mask = np.zeros((2 * B, T_TEXT), np.int32)
    for r in range(2 * B):
        n = T_TEXT - (r // 2) * 2
        ids[r, :n] = rng.integers(1, cfg.text_config.vocab_size - 1, size=n)
        mask[r, :n] = 1
    prefill, steps = dl.prepare_audio_prompt([None] * B, num_channels=cfg.codec_channels,
                                             bos_value=cfg.codec_bos_value,
                                             delay_pattern=cfg.codec_delay_pattern)
    buf = pad_buffer(torch.as_tensor(np.asarray(prefill)), MAX_TOKENS)
    return torch.as_tensor(ids), torch.as_tensor(mask), buf, steps


@pytest.mark.parametrize("chunks", [(None,), (5, 11, None)], ids=["one_call", "resumed"])
@pytest.mark.parametrize("case", list(CASES))
def test_generate_as_before(tiny, case, chunks):
    cfg, params = tiny
    kw = dict(max_tokens=MAX_TOKENS, min_tokens=4, cfg_scale=3.0, temperature=1.0, top_p=1.0,
              cfg_filter_top_k=8, eos_prob_mul_factor=0.6)
    kw.update(CASES[case])
    ids, mask, buf, steps = _inputs(cfg, len(case))
    gen = torch.Generator().manual_seed(0)
    start = int(np.min(steps)) - 1
    state = None
    for stop in chunks:
        res, state = generate(params, cfg, ids, mask, None, buf, steps, gen, state,
                              None if stop is None else start + stop, return_state=True,
                              cache_len=T_TEXT + MAX_TOKENS + 2, **kw)
    arrs = [res.codes, res.lengths, state.eos_countdown, state.finished_step,
            state.eos_detected, state.buf]
    digest = hashlib.sha256(b"".join(np.ascontiguousarray(a.numpy()).tobytes()
                                     for a in arrs)).hexdigest()[:16]
    assert (digest, res.steps, res.lengths.tolist()) == BEFORE[case]
    assert state.graph is None                               # the CPU runs eagerly


# ---------------------------------------------------------------------------
# The eligibility rule.

CUDA = torch.device("cuda")      # a device object only: nothing is allocated on it


@pytest.mark.parametrize("device,kw,ok", [
    (CUDA, dict(), True),
    (CUDA, dict(do_sample=False, keyed=False), True),
    (torch.device("cpu"), dict(), False),
    (CUDA, dict(guidance=True), False),
    (CUDA, dict(keyed=False), False),                 # Generator draws
    (CUDA, dict(decode_emit=False), False),           # the general cache step
], ids=["keyed", "greedy", "cpu", "guidance", "generator", "general_step"])
def test_eligibility(device, kw, ok):
    args = dict(decode_emit=None, guidance=False, do_sample=True, keyed=True)
    args.update(kw)
    assert decode_graph.eligible(device, **args) is ok


def test_eligibility_declines_a_mesh_of_several_ranks(monkeypatch):
    class Mesh:
        shape = {"data": 1, "expert": 2, "model": 1}

        def size(self, axes):
            return int(np.prod([self.shape[a] for a in axes]))

    class Ctx:
        mesh = Mesh()

    monkeypatch.setattr(decode_graph, "active", lambda: Ctx())
    assert not decode_graph.eligible(CUDA, decode_emit=None, guidance=False, do_sample=False,
                                     keyed=False)
    Ctx.mesh.shape = {"data": 1, "expert": 1, "model": 1}
    assert decode_graph.eligible(CUDA, decode_emit=None, guidance=False, do_sample=False,
                                 keyed=False)


# ---------------------------------------------------------------------------
# On the card: replay against the same step run eagerly.

@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs replay only there")
    from unimoe_audio_torch.api import UniMoEAudio

    return UniMoEAudio(config=tiny_test_config(), allow_random=True, device="cuda",
                       serving_mode="int4", kv_cache_dtype="int8")


def _requests(cfg, n):
    from unimoe_audio_torch.apps.continuous import SlotRequest

    prefill, steps = dl.prepare_audio_prompt([None], num_channels=cfg.codec_channels,
                                             bos_value=cfg.codec_bos_value,
                                             delay_pattern=cfg.codec_delay_pattern)
    out = []
    for i in range(n):
        rng = np.random.default_rng(100 + i)
        t = 6 + i % 5
        ids = np.zeros((2, t), np.int32)
        ids[:] = rng.integers(1, cfg.text_config.vocab_size - 1, size=(2, t))
        budget = 12 + (7 * i) % 17
        out.append(SlotRequest(
            input_ids=ids, attention_mask=np.ones((2, t), np.int32),
            prefill=np.asarray(prefill[0]), prefill_steps=int(steps[0]), max_tokens=budget,
            min_tokens=budget // 2, cfg_scale=3.0, temperature=1.0, top_p=0.9,
            eos_prob_mul_factor=20.0 if i % 3 == 0 else 0.6, seed=1000 + i, rid=i))
    return out


def _server(model):
    from unimoe_audio_torch.apps.continuous import SlotServer

    return SlotServer(model.params, model.config, slots=4, t_text=12, horizon=48,
                      chunk_frames=8, decode_dispatch_mode="packed_a8", decode_capacity=8,
                      kv_dtype="int8")


def _same_state(a, b):
    sa, sb = a.state, b.state
    assert sa.dec_step == sb.dec_step
    for n in ("buf", "eos_detected", "eos_countdown", "finished_step", "pos_base"):
        assert torch.equal(getattr(sa, n), getattr(sb, n)), n
    for n in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(getattr(sa.cache, n), getattr(sb.cache, n)), n


@pytest.mark.cuda
def test_slot_server_replays_as_eager(card_model, monkeypatch):
    from unimoe_audio_torch.moe import dispatch
    from unimoe_audio_torch.utils import profiling

    cfg = card_model.config
    graphed, eager = _server(card_model), _server(card_model)
    for srv in (graphed, eager):
        for q in _requests(cfg, 11):
            srv.submit(q)
    decode_calls = {"n": 0}
    forward = loop.text_model_forward

    def counted(params, emb, *a, **k):
        decode_calls["n"] += emb.shape[1] == 1
        return forward(params, emb, *a, **k)

    def step(srv, is_eager, traced):
        """One chunk of srv; returns its results, int8 products and, when
        traced, the program counters of the chunk."""
        with monkeypatch.context() as m:
            if is_eager:
                m.setattr(decode_graph, "eligible", lambda *a, **k: False)
                m.setattr(loop, "text_model_forward", counted)
            calls = dispatch.int8_expert_matmul.calls
            if not traced:
                return srv.step(), dispatch.int8_expert_matmul.calls - calls, None
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                t0 = time.time_ns()
                res = srv.step()
                torch.cuda.synchronize()
                t1 = time.time_ns()
            counters = profiling.recorded(t0, t1)["counters"]
            return res, dispatch.int8_expert_matmul.calls - calls, counters

    captures, replays = decode_graph.DecodeGraph.captures, decode_graph.DecodeGraph.replays
    chunk = 0
    while graphed.queue or graphed.active.any():
        if chunk == 2:
            assert graphed.cancel(graphed.rids[int(np.argmax(graphed.active))])
            assert eager.cancel(eager.rids[int(np.argmax(eager.active))])
        traced = chunk % 2 == 1
        ra, ia, ca = step(graphed, False, traced)
        rb, ib, cb = step(eager, True, traced)
        assert [(r.rid, r.length) for r in ra] == [(r.rid, r.length) for r in rb]
        for x, y in zip(ra, rb):
            assert np.array_equal(x.codes, y.codes)
        _same_state(graphed, eager)
        assert ia == ib
        if traced:
            assert ca["moe.routed_experts"] == cb["moe.routed_experts"] > 0
            assert ca["moe.routed_tokens"] == cb["moe.routed_tokens"] > 0
            assert ca.get("decode.graph_replays", 0) > 0 == cb.get("decode.graph_replays", 0)
        chunk += 1
        assert chunk < 60
    assert graphed.compactions >= 1 and len(graphed.results) == 10
    assert decode_graph.DecodeGraph.captures - captures == 1
    # Every step after the first (eager, before the capture) is a replay.
    assert decode_graph.DecodeGraph.replays - replays == decode_calls["n"] - 1
    assert graphed.state.graph is not None and eager.state.graph is None
