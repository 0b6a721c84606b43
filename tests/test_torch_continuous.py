"""The port's continuous slot server (`unimoe_audio_torch/apps/continuous.py`)
against the JAX package's `SlotServer` and against the port's standalone
`generate`, on the CPU: f32, the tiny 2-layer config, the same weights
through the bridge.  Every case decodes greedily and holds codes and
lengths EQUAL (no tolerance) for each request: one request alone,
admission into a running batch, a voice-prompt request, compaction, a VT2M
request, cancellation (queued and live), the int8 KV cache and a fixed
fuzz schedule; and the oversized-request error.  Sampled requests are
held to composition independence (their codes do not change with the
request beside them) and to their standalone sampled decode.  The JAX
requests use the same token ids and arrays as the port's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vt2m import _videos, stable_tokenizer
from unimoe_audio_torch.apps import continuous as TC
from unimoe_audio_torch.codec import delay as dl
from unimoe_audio_torch.config import tiny_test_config
from unimoe_audio_torch.core.bridge import params_from_jax
from unimoe_audio_torch.generate.loop import generate, pad_buffer
from unimoe_audio_tpu.apps import continuous as JC
from unimoe_audio_tpu.config import tiny_test_config as j_tiny_test_config
from unimoe_audio_tpu.models.model import init_model_params as j_init

T_TEXT = 8


@pytest.fixture(scope="module")
def models():
    """(port cfg, JAX cfg, JAX params, port params): tiny, 2 layers, f32."""
    jcfg = j_tiny_test_config()
    jp = j_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    cfg = tiny_test_config()
    return cfg, jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")


def _request(cfg, seed, *, max_tokens=10, min_tokens=2, text_len=None, prompt_frames=0):
    """Random ids of text_len tokens (right-padded to T_TEXT), an optional
    voice prompt of prompt_frames frames, as `tests/test_continuous.py`."""
    rng = np.random.default_rng(seed)
    tl = text_len or T_TEXT - (seed % 3)
    ids = np.zeros((2, T_TEXT), np.int32)
    mask = np.zeros((2, T_TEXT), np.int32)
    ids[:, :tl] = rng.integers(1, cfg.text_config.vocab_size - 1, size=(2, tl))
    mask[:, :tl] = 1
    prompt = (rng.integers(0, cfg.codec_eos_value, size=(prompt_frames, cfg.codec_channels))
              .astype(np.int32) if prompt_frames else None)
    prefill, steps = dl.prepare_audio_prompt(
        [prompt], num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    return dict(input_ids=ids, attention_mask=mask, prefill=np.asarray(prefill[0]),
                prefill_steps=int(steps[0]), max_tokens=max_tokens, min_tokens=min_tokens,
                cfg_scale=3.0, temperature=1.0, top_p=1.0, eos_prob_mul_factor=0.6, seed=seed,
                rid=f"req{seed}")


def _standalone(cfg, params, req, do_sample=False, t_text=None, kv_dtype=None):
    """The port's `generate` on the request alone (its ids padded to t_text)."""
    ids, mask = req["input_ids"], req["attention_mask"]
    kw = {}
    if t_text is not None:
        t_req = ids.shape[1]
        ids = np.pad(ids, ((0, 0), (0, t_text - t_req)))
        mask = np.pad(mask, ((0, 0), (0, t_text - t_req)))
        if req.get("visual_embeds") is not None:
            ve = np.pad(np.asarray(req["visual_embeds"]), ((0, 0), (0, t_text - t_req), (0, 0)))
            kw = dict(visual_embeds=torch.tensor(ve),
                      visual_mask=torch.tensor(np.pad(req["visual_mask"], ((0, 0), (0, t_text - t_req)))),
                      prefill_position_ids=torch.tensor(np.pad(req["prefill_position_ids"],
                                                               ((0, 0), (0, 0), (0, t_text - t_req)))),
                      rope_deltas=torch.tensor(np.asarray(req["rope_deltas"]).reshape(-1)))
    codec = None
    if req.get("codec_flat") is not None:
        from unimoe_audio_torch.models.model import align_codec_ids

        codec = torch.tensor(align_codec_ids(ids, np.tile(req["codec_flat"], (2, 1)),
                                             cfg.codec_placeholder_value))
    res = generate(
        params, cfg, torch.tensor(ids), torch.tensor(mask), codec,
        pad_buffer(torch.tensor(req["prefill"][None]), req["max_tokens"]),
        [req["prefill_steps"]], torch.Generator(), max_tokens=req["max_tokens"],
        min_tokens=req["min_tokens"], cfg_scale=req["cfg_scale"],
        temperature=req["temperature"], top_p=req["top_p"], cfg_filter_top_k=45,
        eos_prob_mul_factor=req["eos_prob_mul_factor"], sample_seeds=[req["seed"]],
        do_sample=do_sample, kv_dtype=kv_dtype, **kw)
    return res.codes[0].numpy(), int(res.lengths[0])


def _serve(server_cls, req_cls, params, cfg, reqs, *, schedule, **server_kw):
    """Drive a server through `schedule`, a list of actions: ("submit", i),
    ("cancel", rid), ("cancel_slot", slot) (whatever is live there) or
    ("step",); then drain.  Returns ({rid: (codes, length)}, server)."""
    srv = server_cls(params, cfg, **server_kw)
    for action in schedule:
        if action[0] == "submit":
            srv.submit(req_cls(**reqs[action[1]]))
        elif action[0] == "cancel":
            assert srv.cancel(action[1])
        elif action[0] == "cancel_slot":
            if srv.active[action[1]]:
                assert srv.cancel(srv.rids[action[1]])
        else:
            srv.step()
    out = srv.run_until_drained()
    return {r.rid: (np.asarray(r.codes), int(r.length)) for r in out}, srv


def _check_three_ways(models, reqs, schedule, *, standalone_t_text=None, **server_kw):
    """Port server == JAX server == the port's standalone decode, for
    every request that completes.  Returns the port's server."""
    cfg, jcfg, jp, tp = models
    got, srv = _serve(TC.SlotServer, TC.SlotRequest, tp, cfg, reqs, schedule=schedule,
                      **server_kw)
    want, jsrv = _serve(JC.SlotServer, JC.SlotRequest, jp, jcfg,
                        [{**r, "visual_embeds": None if r.get("visual_embeds") is None
                          else np.asarray(r["visual_embeds"])} for r in reqs],
                        schedule=schedule, **server_kw)
    assert set(got) == set(want) and got
    assert srv.compactions == jsrv.compactions
    by_rid = {r["rid"]: r for r in reqs}
    for rid, (codes, length) in got.items():
        assert length == want[rid][1], (rid, length, want[rid][1])
        np.testing.assert_array_equal(codes, want[rid][0], err_msg=str(rid))
        s_codes, s_len = _standalone(cfg, tp, by_rid[rid], t_text=standalone_t_text,
                                     kv_dtype=server_kw.get("kv_dtype"))
        assert length == s_len, (rid, length, s_len)
        np.testing.assert_array_equal(codes, s_codes, err_msg=str(rid))
    return srv


SERVER = dict(slots=2, t_text=T_TEXT, horizon=96, do_sample=False)


def test_single_request(models):
    cfg = models[0]
    _check_three_ways(models, [_request(cfg, 7)], [("submit", 0)], chunk_frames=8, **SERVER)


def test_midflight_admission(models):
    """B admitted while A decodes: decode_start masks B's cache gap,
    seed_step_offset and rope_deltas keep B row-relative."""
    cfg = models[0]
    reqs = [_request(cfg, 1, max_tokens=14), _request(cfg, 2, max_tokens=9, text_len=5)]
    srv = _check_three_ways(models, reqs, [("submit", 0), ("step",), ("submit", 1)],
                            chunk_frames=5, **SERVER)
    assert not srv.active.any()


def test_audio_prompt_request(models):
    """A voice-prompt request (delayed prompt frames) admitted mid-flight:
    the shifted buffer tail merges as it would alone."""
    cfg = models[0]
    reqs = [_request(cfg, 3, max_tokens=8), _request(cfg, 4, max_tokens=16, prompt_frames=6)]
    _check_three_ways(models, reqs, [("submit", 0), ("step",), ("submit", 1)], chunk_frames=4,
                      **SERVER)


def test_compaction(models):
    """More requests than the horizon holds: the cache compacts and every
    result still equals its standalone decode."""
    cfg = models[0]
    reqs = [_request(cfg, 10 + i, max_tokens=10) for i in range(5)]
    srv = _check_three_ways(models, reqs, [("submit", i) for i in range(5)], slots=2,
                            t_text=T_TEXT, horizon=48, chunk_frames=6, do_sample=False)
    assert srv.compactions >= 1


def test_cancel_queued_and_live(models):
    """A queued request dropped before admission, a live one freed
    mid-flight; the survivor equals its standalone decode."""
    cfg = models[0]
    reqs = [_request(cfg, 40, max_tokens=14), _request(cfg, 41, max_tokens=10),
            _request(cfg, 42, max_tokens=10)]
    schedule = [("submit", 0), ("submit", 1), ("submit", 2), ("cancel", "req41"), ("step",),
                ("cancel", "req40")]
    _check_three_ways(models, reqs, schedule, chunk_frames=4, **SERVER)
    cfg, _, _, tp = models
    srv = TC.SlotServer(tp, cfg, **SERVER)
    assert not srv.cancel("nonexistent")


def test_int8_kv_cache(models):
    """kv_dtype="int8": the spliced rows carry their scales, compaction
    rolls them with k and v."""
    cfg = models[0]
    reqs = [_request(cfg, 50 + i, max_tokens=11) for i in range(3)]
    _check_three_ways(models, reqs, [("submit", 0), ("step",), ("submit", 1), ("submit", 2)],
                      slots=2, t_text=T_TEXT, horizon=40, chunk_frames=5, do_sample=False,
                      kv_dtype="int8")


def test_fuzz_schedule(models):
    """A fixed random schedule (budgets, text lengths, voice prompts,
    bursts, a live cancellation) through a small horizon that compacts
    repeatedly."""
    cfg = models[0]
    rng = np.random.default_rng(2024)
    reqs = [_request(cfg, 100 + i, max_tokens=int(rng.integers(8, 18)),
                     text_len=int(rng.integers(3, T_TEXT)),
                     prompt_frames=int(rng.integers(0, 2)) * 3) for i in range(9)]
    schedule, pending = [], list(range(9))
    for it in range(12):
        for _ in range(int(rng.integers(0, 3))):
            if pending:
                schedule.append(("submit", pending.pop(0)))
        if it == 5:
            schedule.append(("cancel_slot", 1))
        schedule.append(("step",))
    schedule += [("submit", i) for i in pending]
    srv = _check_three_ways(models, reqs, schedule, slots=3, t_text=T_TEXT, horizon=56,
                            chunk_frames=4, do_sample=False)
    assert srv.compactions >= 2


def test_oversized_request_raises(models):
    cfg, _, _, tp = models
    srv = TC.SlotServer(tp, cfg, slots=1, t_text=T_TEXT, horizon=32, chunk_frames=4)
    with pytest.raises(ValueError, match="horizon"):
        srv.submit(TC.SlotRequest(**_request(cfg, 5, max_tokens=64)))
    with pytest.raises(ValueError, match="t_text"):
        srv.submit(TC.SlotRequest(**{**_request(cfg, 5), "input_ids": np.zeros((2, 9), np.int32),
                                     "attention_mask": np.ones((2, 9), np.int32)}))


def test_sampled_requests_are_composition_independent(models):
    """Sampled, dense dispatch: a request's codes do not change with the
    request decoded beside it, and equal its standalone sampled decode
    (the same counter-based chain from its seed)."""
    cfg, _, _, tp = models
    target = _request(cfg, 42, max_tokens=12)
    outs = []
    for co in (91, 92):
        got, _ = _serve(TC.SlotServer, TC.SlotRequest, tp, cfg,
                        [_request(cfg, co, max_tokens=11), target],
                        schedule=[("submit", 0), ("step",), ("submit", 1)], slots=2,
                        t_text=T_TEXT, horizon=64, chunk_frames=4, do_sample=True)
        outs.append(got[target["rid"]])
    codes, length = _standalone(cfg, tp, target, do_sample=True)
    for c, n in outs:
        assert n == length
        np.testing.assert_array_equal(c, codes)


@pytest.fixture(scope="module")
def vision_models():
    """The JAX and port API models, tiny with the vision tower, f32, the
    same weights and the crc32 tokenizer."""
    from unimoe_audio_torch.api import UniMoEAudio
    from unimoe_audio_tpu import api as JAPI

    jcfg = j_tiny_test_config(with_vision=True)
    jm = JAPI.UniMoEAudio(allow_random=True, config=jcfg, dtype=jnp.float32, max_tokens=10,
                          min_tokens=2, tokenizer=stable_tokenizer(jcfg))
    tm = UniMoEAudio(allow_random=True, config=tiny_test_config(with_vision=True), device="cpu",
                     dtype=torch.float32, max_tokens=10, min_tokens=2, tokenizer=jm.tokenizer)
    tm.params = params_from_jax(jax.tree.map(np.asarray, jm.params), tm.config, "cpu")
    return jm, tm


def _fields(req):
    return {f: getattr(req, f) for f in TC.SlotRequest.__dataclass_fields__}


def test_vt2m_request_midflight(vision_models):
    """`make_slot_request("vt2m")` builds the JAX package's request (ids,
    mask, positions and deltas equal, tower features within 1e-5); the
    video request admitted mid-flight beside a text request gives the JAX
    server's codes and its standalone decode's."""
    jm, tm = vision_models
    video = _videos()[0]
    kw = dict(caption="drums", video=video, seed=5, max_audio_seconds=0.2, rid="vid")
    vreq, jvreq = tm.make_slot_request("vt2m", **kw), jm.make_slot_request("vt2m", **kw)
    for f in ("input_ids", "attention_mask", "prefill_position_ids", "rope_deltas", "prefill"):
        np.testing.assert_array_equal(np.asarray(getattr(vreq, f)), np.asarray(getattr(jvreq, f)))
    np.testing.assert_allclose(vreq.visual_embeds.numpy(), jvreq.visual_embeds, atol=1e-5,
                               rtol=1e-5)
    treq = tm.make_slot_request("t2m", caption="calm tune", seed=6, max_audio_seconds=0.2,
                                rid="txt")
    # Both servers decode the JAX request's arrays (the tower's last bits
    # differ between the frameworks).
    reqs = [_fields(treq), {**_fields(vreq), "visual_embeds": np.asarray(jvreq.visual_embeds)}]
    t_text = max(r["input_ids"].shape[1] for r in reqs)
    models = (tm.config, jm.config, jm.params, tm.params)
    _check_three_ways(models, reqs, [("submit", 0), ("step",), ("submit", 1)],
                      standalone_t_text=t_text, slots=2, t_text=t_text, horizon=64,
                      chunk_frames=3, do_sample=False)


def test_api_surface(tmp_path, vision_models):
    """`continuous_server` (dense unless a wide serving-mode server; the
    deterministic flag), `make_slot_request` for T2M and TTS (codes in the
    placeholders) and `decode_slot_results` writing one wav per result."""
    _, tm = vision_models
    srv = tm.continuous_server(slots=2, t_text=128, horizon=64, chunk_frames=6, do_sample=True)
    assert srv.dispatch["decode_dispatch_mode"] is None and srv.cache_len == 128 + 64 + 2
    assert tm.continuous_server(slots=1, chunk_frames=8).H_frames == tm.MAX_TOKENS + 512 + 32
    tm.serving_mode = "int8"          # the width policy only; the params stay f32
    try:
        wide = tm.continuous_server(slots=32, t_text=8, horizon=16, chunk_frames=4)
        det = tm.continuous_server(slots=32, t_text=8, horizon=16, chunk_frames=4,
                                   deterministic=True)
    finally:
        tm.serving_mode = False
    assert wide.dispatch["decode_dispatch_mode"] == "packed_a8"
    assert wide.dispatch["decode_capacity"] == 48
    assert det.dispatch["decode_dispatch_mode"] is None
    prompt_codec = np.random.default_rng(0).integers(0, tm.config.codec_eos_value,
                                                     size=(3, tm.config.codec_channels))
    srv.submit(tm.make_slot_request("t2m", caption="a slow piano piece", seed=1,
                                    max_audio_seconds=0.24, rid="music"))
    tts = tm.make_slot_request("tts", caption="hello world", prompt_text="ref transcript",
                               prompt_codec=prompt_codec, seed=2, max_audio_seconds=0.4,
                               rid="speech")
    assert tts.codec_flat.shape[0] == int((tts.input_ids[1] == tm.config.codec_placeholder_value).sum())
    srv.submit(tts)
    results = srv.run_until_drained()
    assert {r.rid for r in results} == {"music", "speech"}
    paths = tm.decode_slot_results(results, output_dir=str(tmp_path))
    assert sorted(p.rsplit("/", 1)[1] for p in paths) == [
        "generated_continuous_music.wav", "generated_continuous_speech.wav"]
    with pytest.raises(ValueError, match="unsupported"):
        tm.make_slot_request("bogus", caption="x")
