"""The int8 KV cache of the PyTorch port vs the JAX package, on the CPU:

  * `quantize_kv`: q and s bit-equal (the 1e-6 floor on an all-zero head
    included);
  * `KVCache.create(dtype="int8")` and `grow`, which carries the scales;
  * attention into and over an int8 cache (the prefill's cache branch and a
    decode_emit step, scales on the scores and on the probabilities), and
    the decoder stack's prefill + decode commit, f32 at 1e-5 (the decode
    step's int8 slot and scale equal JAX's);
  * greedy `generate` with the int8 cache (one call and chunked, the scales
    growing between chunks): codes and lengths equal JAX `generate_jit`'s.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unimoe_audio_tpu.codec import delay as JDL
from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.generate.loop import generate_jit, pad_buffer as j_pad_buffer
from unimoe_audio_tpu.models import layers as JL
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_torch.core.bridge import params_from_jax, to_torch
from unimoe_audio_torch.generate.loop import generate, generate_chunked, pad_buffer
from unimoe_audio_torch.models import layers as TL
from unimoe_audio_torch.models import model as TM

TOL = dict(rtol=1e-5, atol=1e-5)
MAX_TOKENS = 20
KNOBS = dict(min_tokens=6, cfg_scale=3.0, temperature=1.0, top_p=1.0, cfg_filter_top_k=16,
             eos_prob_mul_factor=1.0)


def test_quantize_kv_bit_equal():
    x = np.random.default_rng(0).standard_normal((3, 5, 2, 64)).astype(np.float32)
    x[1, 2, 0] = 0.0
    wq, ws = JL.quantize_kv(jnp.asarray(x))
    q, s = TL.quantize_kv(torch.tensor(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    assert q.dtype == torch.int8 and s.shape == (3, 5, 2)
    assert float(s[1, 2, 0]) == np.float32(1e-6) / np.float32(127.0)


def test_kvcache_create_and_grow_int8():
    c = TL.KVCache.create(2, 4, 16, 2, 8, dtype="int8", device="cpu")
    assert c.quantized and c.k.dtype == torch.int8 and c.k.shape == (2, 16, 4, 2, 8)
    assert c.k_scale.shape == (2, 16, 4, 2) and c.k_scale.dtype == torch.float32
    c.k.random_(-100, 100)
    c.v.random_(-100, 100)
    c.k_scale.uniform_()
    c.v_scale.uniform_()
    g = c.grow(24)
    assert g.quantized and g.k.shape[1] == 24 and g.k_scale.shape[1] == 24
    for a, b in ((g.k, c.k), (g.v, c.v), (g.k_scale, c.k_scale), (g.v_scale, c.v_scale)):
        assert torch.equal(a[:, :16], b) and not a[:, 16:].any()
    b = TL.KVCache.create(2, 4, 16, 2, 8, device="cpu")
    assert not b.quantized and b.k_scale is None and not b.grow(20).quantized


@pytest.fixture(scope="module")
def attn_setup():
    cfg = tiny_test_config().text_config
    jp = JL.init_attention_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    for name in ("q_proj", "k_proj", "v_proj"):
        jp[name]["b"] = jnp.asarray(rng.standard_normal(jp[name]["b"].shape).astype(np.float32))
    return cfg, jp, to_torch(jax.tree.map(np.asarray, jp), "cpu", torch.float32)


def test_attention_int8_cache_prefill_and_decode(attn_setup):
    cfg, jp, tp = attn_setup
    B, T, T_max = 2, 6, 10
    KV, Dh = cfg.num_key_value_heads, cfg.head_dim
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, T, cfg.hidden_size)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T)[None, None], (3, B, T)).copy()
    valid = np.zeros((B, T_max), np.int32)
    valid[:, :T] = 1
    valid[0, :2] = 0
    jc, js = JL.compute_mrope(jnp.asarray(pos), Dh, cfg.rope_theta, cfg.mrope_section)
    tcs, tsn = TL.compute_mrope(torch.tensor(pos), Dh, cfg.rope_theta, cfg.mrope_section)
    jcache = JL.KVCache.create(1, B, T_max, KV, Dh, dtype=jnp.int8)
    want, (wk, wv, wks, wvs) = JL.attention(
        jp, jnp.asarray(x), jc, js, cfg, cache_kv=(jcache.k[0], jcache.v[0]),
        cache_scales=(jcache.k_scale[0], jcache.v_scale[0]), cache_position=jnp.int32(0),
        kv_valid_mask=jnp.asarray(valid))
    tcache = TL.KVCache.create(1, B, T_max, KV, Dh, dtype="int8", device="cpu")
    got, _ = TL.attention(tp, torch.tensor(x), tcs, tsn, cfg,
                          cache_kv=(tcache.k[0], tcache.v[0]),
                          cache_scales=(tcache.k_scale[0], tcache.v_scale[0]),
                          cache_position=0, kv_valid_mask=torch.tensor(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # The cache was written in place, quantized: int8 values within one step
    # of JAX's (k, v from f32 products in another order), scales to 1e-6.
    assert np.abs(tcache.k[0].numpy().astype(int) - np.asarray(wk).astype(int)).max() <= 1
    assert np.abs(tcache.v[0].numpy().astype(int) - np.asarray(wv).astype(int)).max() <= 1
    np.testing.assert_allclose(tcache.k_scale[0].numpy(), np.asarray(wks), rtol=1e-6)
    np.testing.assert_allclose(tcache.v_scale[0].numpy(), np.asarray(wvs), rtol=1e-6)

    # decode_emit at slot T over the same (JAX's) int8 cache, current slot masked.
    xd = rng.standard_normal((B, 1, cfg.hidden_size)).astype(np.float32)
    pd = np.full((3, B, 1), T)
    jc, js = JL.compute_mrope(jnp.asarray(pd), Dh, cfg.rope_theta, cfg.mrope_section)
    tcs, tsn = TL.compute_mrope(torch.tensor(pd), Dh, cfg.rope_theta, cfg.mrope_section)
    want, (jk, jv) = JL.attention(jp, jnp.asarray(xd), jc, js, cfg, cache_kv=(wk, wv),
                                  cache_scales=(wks, wvs), cache_position=jnp.int32(T),
                                  kv_valid_mask=jnp.asarray(valid), decode_emit=True)
    got, (gk, gv) = TL.attention(
        tp, torch.tensor(xd), tcs, tsn, cfg,
        cache_kv=(torch.tensor(np.asarray(wk)), torch.tensor(np.asarray(wv))),
        cache_scales=(torch.tensor(np.asarray(wks)), torch.tensor(np.asarray(wvs))),
        cache_position=T, kv_valid_mask=torch.tensor(valid), decode_emit=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(jk), **TOL)


def test_text_model_int8_cache_prefill_and_commit():
    cfg = tiny_test_config()
    tc = cfg.text_config
    jp = JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    B, T, T_max = 2, 8, 12
    rng = np.random.default_rng(2)
    ids = rng.integers(0, tc.vocab_size - 8, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[1, :3] = 0
    pos3 = np.broadcast_to(np.where(mask == 0, 1, np.cumsum(mask, -1) - 1)[None], (3, B, T)).copy()
    kv_valid = np.concatenate([mask, np.zeros((B, T_max - T), np.int32)], -1)
    j_emb = JM.calculate_input_embedding(jp, jnp.asarray(ids), None, cfg.codec_placeholder_value)
    jcache = JL.KVCache.create(tc.num_hidden_layers, B, T_max, tc.num_key_value_heads,
                               tc.head_dim, dtype=jnp.int8)
    jout = JM.text_model_forward(jp, j_emb, jnp.asarray(pos3), tc, kv_cache=jcache,
                                 cache_position=jnp.int32(0), kv_valid_mask=jnp.asarray(kv_valid),
                                 padding_token_mask=jnp.asarray(mask))
    t_emb = TM.calculate_input_embedding(tp, torch.tensor(ids), None, cfg.codec_placeholder_value)
    tcache = TL.KVCache.create(tc.num_hidden_layers, B, T_max, tc.num_key_value_heads,
                               tc.head_dim, dtype="int8", device="cpu")
    tout = TM.text_model_forward(tp, t_emb, torch.tensor(pos3), tc, kv_cache=tcache,
                                 cache_position=0, kv_valid_mask=torch.tensor(kv_valid),
                                 padding_token_mask=torch.tensor(mask))
    np.testing.assert_allclose(tout.last_hidden_state.numpy(),
                               np.asarray(jout.last_hidden_state), **TOL)

    # One decode step from JAX's cache: the commit writes the quantized slot.
    tcache.k.copy_(torch.tensor(np.asarray(jout.kv_cache.k)))
    tcache.v.copy_(torch.tensor(np.asarray(jout.kv_cache.v)))
    tcache.k_scale.copy_(torch.tensor(np.asarray(jout.kv_cache.k_scale)))
    tcache.v_scale.copy_(torch.tensor(np.asarray(jout.kv_cache.v_scale)))
    codes = rng.integers(0, cfg.codec_embed_size, size=(B, 1, cfg.codec_channels))
    step_valid = kv_valid.copy()
    step_valid[:, T] = 1
    step_pos = np.broadcast_to(mask.sum(-1)[None, :, None], (3, B, 1)).copy()
    jstep = JM.text_model_forward(jp, JM.codec_embedding(jp, jnp.asarray(codes)),
                                  jnp.asarray(step_pos), tc, kv_cache=jout.kv_cache,
                                  cache_position=jnp.int32(T),
                                  kv_valid_mask=jnp.asarray(step_valid))
    tstep = TM.text_model_forward(tp, TM.codec_embedding(tp, torch.tensor(codes)),
                                  torch.tensor(step_pos), tc, kv_cache=tcache, cache_position=T,
                                  kv_valid_mask=torch.tensor(step_valid))
    np.testing.assert_allclose(tstep.last_hidden_state.numpy(),
                               np.asarray(jstep.last_hidden_state), **TOL)
    for got, want in ((tcache.k, jstep.kv_cache.k), (tcache.v, jstep.kv_cache.v)):
        assert np.abs(got.numpy().astype(int) - np.asarray(want).astype(int)).max() <= 1
    np.testing.assert_allclose(tcache.k_scale.numpy(), np.asarray(jstep.kv_cache.k_scale),
                               rtol=1e-5)
    assert (tcache.k_scale[:, T] > 0).all() and not tcache.k_scale[:, T + 1:].any()


@pytest.fixture(scope="module")
def gen_setup():
    cfg = tiny_test_config()
    jp = JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    B, T = 2, 12
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.text_config.vocab_size - 8, size=(2 * B, T)).astype(np.int32)
    mask = np.ones((2 * B, T), np.int32)
    mask[0, :5] = 0
    prefill, steps = JDL.prepare_audio_prompt(
        [None] * B, num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    want = generate_jit(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask), None, j_pad_buffer(prefill, MAX_TOKENS),
        jnp.asarray(steps, jnp.int32), jax.random.PRNGKey(0), max_tokens=MAX_TOKENS,
        min_tokens=jnp.int32(KNOBS["min_tokens"]), cfg_scale=jnp.float32(KNOBS["cfg_scale"]),
        temperature=jnp.float32(1.0), top_p=jnp.float32(1.0),
        cfg_filter_top_k=KNOBS["cfg_filter_top_k"], eos_prob_mul_factor=jnp.float32(1.0),
        do_sample=False, kv_dtype="int8")
    return cfg, tp, ids, mask, np.asarray(prefill), steps, want


@pytest.mark.parametrize("chunk_frames", [None, 8])
def test_greedy_int8_cache_codes_equal_jax(gen_setup, chunk_frames):
    cfg, tp, ids, mask, prefill, steps, want = gen_setup
    args = (tp, cfg, torch.tensor(ids), torch.tensor(mask), None,
            pad_buffer(torch.tensor(prefill), MAX_TOKENS), steps, torch.Generator())
    kw = dict(max_tokens=MAX_TOKENS, do_sample=False, kv_dtype="int8", **KNOBS)
    if chunk_frames is None:
        got, state = generate(*args, return_state=True, **kw)
    else:
        got, state = generate_chunked(*args, chunk_frames=chunk_frames, return_state=True, **kw)
        assert state.cache.k.shape[1] > chunk_frames * 4 and got.steps > chunk_frames
    assert state.cache.quantized and state.cache.k.dtype == torch.int8
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.steps == int(want.steps)
