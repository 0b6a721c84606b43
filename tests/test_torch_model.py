"""Decoder stack of the PyTorch port vs the JAX package, f32 on the CPU:
a prefill into the cache and one decode_emit step of `text_model_forward`
(atol 1e-4), the codec embedding and `codec_logits_from_hidden`, and the
weight bridge."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.models.layers import KVCache as JKV
from unimoe_audio_tpu.ops.quant import quantize_tensor
from unimoe_audio_torch.core.bridge import params_from_jax
from unimoe_audio_torch.models import model as TM
from unimoe_audio_torch.models.layers import KVCache as TKV

ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    jp = JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return cfg, jp, tree, params_from_jax(tree, cfg, "cpu", torch.float32)


def test_bridge_unstacks_layers(setup):
    cfg, _, tree, tp = setup
    L = cfg.text_config.num_hidden_layers
    assert len(tp["layers"]) == L
    for i in range(L):
        np.testing.assert_array_equal(tp["layers"][i]["moe"]["dynamic"]["up"].numpy(),
                                      tree["layers"]["moe"]["dynamic"]["up"][i])
        np.testing.assert_array_equal(tp["layers"][i]["attn"]["q_proj"]["b"].numpy(),
                                      tree["layers"]["attn"]["q_proj"]["b"][i])
    assert tp["layers"][0]["moe"]["gate"].dtype == torch.float32


def test_bridge_rejects_quantized_leaves(setup):
    """A JAX QTensor leaf bridges to the port's QTensor (q and s equal), and
    a malformed one, whose scales do not fit q, is rejected by name."""
    cfg, _, tree, _ = setup
    ok = jax.tree.map(lambda x: x, tree)
    qt = jax.tree.map(np.asarray, quantize_tensor(jnp.asarray(tree["lm_head"])))
    ok["lm_head"] = qt
    got = params_from_jax(ok, cfg, "cpu")["lm_head"]
    np.testing.assert_array_equal(got.q.numpy(), qt.q)
    np.testing.assert_array_equal(got.s.numpy(), qt.s)
    bad = jax.tree.map(lambda x: x, tree)
    bad["lm_head"] = type(qt)(q=qt.q, s=qt.s[..., :3])
    with pytest.raises(ValueError, match="QTensor"):
        params_from_jax(bad, cfg, "cpu")


def test_prefill_then_decode_emit_step(setup):
    cfg, jp, _, tp = setup
    tc = cfg.text_config
    B, T, T_max = 2, 10, 16
    rng = np.random.default_rng(1)
    ids = rng.integers(0, tc.vocab_size - 8, size=(B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    mask[0, :4] = 0
    pos = np.where(mask == 0, 1, np.cumsum(mask, -1) - 1)
    pos3 = np.broadcast_to(pos[None], (3, B, T)).copy()
    kv_valid = np.concatenate([mask, np.zeros((B, T_max - T), np.int32)], -1)

    j_emb = JM.calculate_input_embedding(jp, jnp.asarray(ids), None, cfg.codec_placeholder_value)
    t_emb = TM.calculate_input_embedding(tp, torch.tensor(ids), None, cfg.codec_placeholder_value)
    np.testing.assert_array_equal(t_emb.numpy(), np.asarray(j_emb))

    jcache = JKV.create(tc.num_hidden_layers, B, T_max, tc.num_key_value_heads, tc.head_dim,
                        dtype=jnp.float32)
    jout = JM.text_model_forward(jp, j_emb, jnp.asarray(pos3), tc, kv_cache=jcache,
                                 cache_position=jnp.int32(0), kv_valid_mask=jnp.asarray(kv_valid),
                                 padding_token_mask=jnp.asarray(mask))
    tcache = TKV.create(tc.num_hidden_layers, B, T_max, tc.num_key_value_heads, tc.head_dim,
                        dtype=torch.float32, device="cpu")
    tout = TM.text_model_forward(tp, t_emb, torch.tensor(pos3), tc, kv_cache=tcache,
                                 cache_position=0, kv_valid_mask=torch.tensor(kv_valid),
                                 padding_token_mask=torch.tensor(mask))
    np.testing.assert_allclose(tout.last_hidden_state.numpy(),
                               np.asarray(jout.last_hidden_state), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jout.kv_cache.k), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jout.kv_cache.v), atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(tout.router_top_k.numpy(), np.asarray(jout.router_top_k))

    # One decode_emit step at slot T, from a codec frame.
    codes = rng.integers(0, cfg.codec_embed_size, size=(B, 1, cfg.codec_channels)).astype(np.int32)
    j_e = JM.codec_embedding(jp, jnp.asarray(codes))
    t_e = TM.codec_embedding(tp, torch.tensor(codes))
    np.testing.assert_allclose(t_e.numpy(), np.asarray(j_e), atol=1e-6, rtol=1e-6)
    step_valid = kv_valid.copy()
    step_valid[:, T] = 1
    step_pos = np.broadcast_to(mask.sum(-1)[None, :, None], (3, B, 1)).copy()
    jstep = JM.text_model_forward(jp, j_e, jnp.asarray(step_pos), tc, kv_cache=jout.kv_cache,
                                  cache_position=jnp.int32(T),
                                  kv_valid_mask=jnp.asarray(step_valid))
    tstep = TM.text_model_forward(tp, t_e, torch.tensor(step_pos), tc, kv_cache=tcache,
                                  cache_position=T, kv_valid_mask=torch.tensor(step_valid))
    np.testing.assert_allclose(tstep.last_hidden_state.numpy(),
                               np.asarray(jstep.last_hidden_state), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jstep.kv_cache.k), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jstep.kv_cache.v), atol=ATOL, rtol=ATOL)

    jl = JM.codec_logits_from_hidden(jp, jstep.last_hidden_state, cfg)
    tl = TM.codec_logits_from_hidden(tp, tstep.last_hidden_state, cfg)
    assert tl.shape == (B, 1, cfg.codec_channels, cfg.codec_embed_size)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)


def test_init_model_params_layout(setup):
    """The port's random init has the bridged layout, dtypes and shapes."""
    cfg, _, _, tp = setup
    mine = TM.init_model_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    assert len(mine["layers"]) == len(tp["layers"])

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}[{i}]")
        else:
            assert a.shape == b.shape, path
            want = torch.float32 if path.endswith("moe/gate") else torch.bfloat16
            assert a.dtype == want, path

    walk(mine, tp)
