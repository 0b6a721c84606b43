"""Transformer layers of the PyTorch port vs the JAX package, f32 on the
CPU: RMSNorm and mRoPE at 1e-5, and one attention layer in each of its
three modes (no cache; prefill into the cache; decode_emit) at 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.models import layers as JL
from unimoe_audio_torch.core.bridge import to_torch
from unimoe_audio_torch.models import layers as TL

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config().text_config
    jp = JL.init_attention_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    # Non-zero biases so the bias path is exercised.
    rng = np.random.default_rng(0)
    for name in ("q_proj", "k_proj", "v_proj"):
        jp[name]["b"] = jnp.asarray(rng.standard_normal(jp[name]["b"].shape).astype(np.float32) * 0.1)
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    return cfg, jp, tp


def _rope(cfg, position_ids):
    jc, js = JL.compute_mrope(jnp.asarray(position_ids), cfg.head_dim, cfg.rope_theta,
                              cfg.mrope_section)
    tc, ts = TL.compute_mrope(torch.tensor(position_ids), cfg.head_dim, cfg.rope_theta,
                              cfg.mrope_section)
    return (jc, js), (tc, ts)


def test_rms_norm():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    want = _np(JL.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = TL.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_mrope_and_apply_rope():
    cfg = tiny_test_config().text_config
    rng = np.random.default_rng(2)
    # Distinct (t, h, w) rows so every mrope section reads its own row.
    pos = rng.integers(0, 500, size=(3, 2, 7))
    (jc, js), (tc, ts) = _rope(cfg, pos)
    np.testing.assert_allclose(tc.numpy(), _np(jc), **TOL)
    np.testing.assert_allclose(ts.numpy(), _np(js), **TOL)
    q = rng.standard_normal((2, 7, 4, cfg.head_dim)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, cfg.head_dim)).astype(np.float32)
    jq, jk = JL.apply_rope(jnp.asarray(q), jnp.asarray(k), jc, js)
    tq, tk = TL.apply_rope(torch.tensor(q), torch.tensor(k), tc, ts)
    np.testing.assert_allclose(tq.numpy(), _np(jq), **TOL)
    np.testing.assert_allclose(tk.numpy(), _np(jk), **TOL)


def _left_padded(B, T, pad):
    mask = np.ones((B, T), np.int32)
    mask[0, :pad] = 0
    pos = np.cumsum(mask, -1) - 1
    pos = np.where(mask == 0, 1, pos)
    return mask, np.broadcast_to(pos[None], (3, B, T)).copy()


def test_attention_no_cache(setup):
    cfg, jp, tp = setup
    B, T = 2, 9
    x = np.random.default_rng(4).standard_normal((B, T, cfg.hidden_size)).astype(np.float32)
    mask, pos = _left_padded(B, T, 3)
    (jc, js), (tc, ts) = _rope(cfg, pos)
    want, _ = JL.attention(jp, jnp.asarray(x), jc, js, cfg, kv_valid_mask=jnp.asarray(mask),
                           use_flash=False)
    got, cache = TL.attention(tp, torch.tensor(x), tc, ts, cfg, kv_valid_mask=torch.tensor(mask))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("flash", [False, True])
def test_attention_prefill_into_cache(setup, flash):
    """cache_position 0 prefill: output and the written cache match.  The
    flash route (plain version on the CPU) matches on every live row; dead
    (left-pad) rows are 0 there instead of the einsum's uniform average."""
    cfg, jp, tp = setup
    B, T, T_max = 2, 9, 16
    KV, Dh = cfg.num_key_value_heads, cfg.head_dim
    x = np.random.default_rng(5).standard_normal((B, T, cfg.hidden_size)).astype(np.float32)
    mask, pos = _left_padded(B, T, 3)
    kv_valid = np.concatenate([mask, np.zeros((B, T_max - T), np.int32)], -1)
    (jc, js), (tc, ts) = _rope(cfg, pos)
    zeros = jnp.zeros((T_max, B, KV, Dh), jnp.float32)
    want, (wk, wv) = JL.attention(jp, jnp.asarray(x), jc, js, cfg, cache_kv=(zeros, zeros),
                                  cache_position=jnp.int32(0),
                                  kv_valid_mask=jnp.asarray(kv_valid), use_flash=False)
    ck, cv = torch.zeros(T_max, B, KV, Dh), torch.zeros(T_max, B, KV, Dh)
    got, (gk, gv) = TL.attention(tp, torch.tensor(x), tc, ts, cfg, cache_kv=(ck, cv),
                                 cache_position=0, kv_valid_mask=torch.tensor(kv_valid),
                                 use_flash=flash)
    assert gk is ck and gv is cv, "the cache is written in place"
    np.testing.assert_allclose(gk.numpy(), _np(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), _np(wv), **TOL)
    live = mask.astype(bool) if flash else np.ones_like(mask, bool)
    np.testing.assert_allclose(got.numpy()[live], _np(want)[live], **TOL)
    if flash:
        assert (got.numpy()[~live] == 0).all()


def test_attention_decode_emit(setup):
    cfg, jp, tp = setup
    B, T_max, pos_now = 2, 16, 11
    KV, Dh = cfg.num_key_value_heads, cfg.head_dim
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, 1, cfg.hidden_size)).astype(np.float32)
    ck = rng.standard_normal((T_max, B, KV, Dh)).astype(np.float32)
    cv = rng.standard_normal((T_max, B, KV, Dh)).astype(np.float32)
    valid = (np.arange(T_max)[None, :] < pos_now).astype(np.int32).repeat(B, 0)
    valid[0, :2] = 0                                      # left padding
    pos = np.full((3, B, 1), pos_now, np.int64)
    (jc, js), (tc, ts) = _rope(cfg, pos)
    want, (wk, wv) = JL.attention(jp, jnp.asarray(x), jc, js, cfg,
                                  cache_kv=(jnp.asarray(ck), jnp.asarray(cv)),
                                  cache_position=jnp.int32(pos_now),
                                  kv_valid_mask=jnp.asarray(valid), decode_emit=True)
    got, (gk, gv) = TL.attention(tp, torch.tensor(x), tc, ts, cfg,
                                 cache_kv=(torch.tensor(ck), torch.tensor(cv)),
                                 cache_position=pos_now, kv_valid_mask=torch.tensor(valid),
                                 decode_emit=True)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(gk.numpy(), _np(wk), **TOL)
    np.testing.assert_allclose(gv.numpy(), _np(wv), **TOL)


def test_unported_modes_raise(setup):
    cfg, _, tp = setup
    x = torch.zeros(1, 1, cfg.hidden_size)
    cos = sin = torch.zeros(1, 1, cfg.head_dim)
    with pytest.raises(NotImplementedError):
        TL.attention(tp, x, cos, sin, cfg, ring=(1, 1))
