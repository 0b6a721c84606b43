"""Sliding-window layers of the PyTorch port vs the JAX package, f32 on the
CPU: the JAX test's one-layer windowed case (`tests/test_model.py:130-170`)
— the windowed output equals JAX's and the forward over the window's
tail alone —, greedy generation (a prefill and cached decode steps) over a
2-layer model with one sliding and one full layer equal to JAX's
`generate_jit`, the training loss and gradients of such a model equal to
JAX's, and no flash launch for a model that has sliding layers, even when
the caller asks for flash."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import GRAD_ATOL_REL, GRAD_RTOL, LOSS_RTOL, _assert_tree_close, \
    _batch, _grads, _tensors
from unimoe_audio_tpu.codec import delay as JD
from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.generate.loop import generate_jit, pad_buffer as j_pad_buffer
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.train import step as JS
from unimoe_audio_torch.core.bridge import params_from_jax
from unimoe_audio_torch.generate.loop import generate, pad_buffer
from unimoe_audio_torch.models import model as TM
from unimoe_audio_torch.ops import flash_attention as FA
from unimoe_audio_torch.train import step as TS

MAX_TOKENS = 16
KNOBS = dict(min_tokens=6, cfg_scale=3.0, temperature=1.0, top_p=1.0, cfg_filter_top_k=16,
             eos_prob_mul_factor=1.0)


def _sliding(cfg, window, types):
    tc = dataclasses.replace(cfg.text_config, use_sliding_window=True, sliding_window=window,
                             layer_types=types)
    return dataclasses.replace(cfg, text_config=tc)


def _params(cfg):
    jp = JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)


def test_one_layer_window_matches_jax():
    cfg = _sliding(tiny_test_config(num_hidden_layers=1), 3, ("sliding_attention",))
    tc = cfg.text_config
    jp, tp = _params(cfg)
    T = 10
    emb = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, T, tc.hidden_size)) * 0.1)
    pos = np.broadcast_to(np.arange(T)[None, None], (3, 1, T)).copy()
    want = np.asarray(JM.text_model_forward(jp, jnp.asarray(emb), jnp.asarray(pos), tc)
                      .last_hidden_state)
    got = TM.text_model_forward(tp, torch.tensor(emb), torch.tensor(pos), tc).last_hidden_state
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    # The window's tail alone gives the last position's state; full
    # attention does not.
    tail = TM.text_model_forward(tp, torch.tensor(emb[:, T - 3:]), torch.tensor(pos[:, :, T - 3:]),
                                 tc).last_hidden_state
    np.testing.assert_allclose(got[:, -1].numpy(), tail[:, -1].numpy(), rtol=2e-4, atol=2e-5)
    full = dataclasses.replace(tc, use_sliding_window=False, layer_types=None)
    out_full = TM.text_model_forward(tp, torch.tensor(emb), torch.tensor(pos), full)
    assert not np.allclose(got[:, -1].numpy(), out_full.last_hidden_state[:, -1].numpy(),
                           atol=1e-4)


@pytest.fixture
def no_flash(monkeypatch):
    """The flash kernel's function, replaced by one that fails the test."""
    def refuse(*a, **k):
        raise AssertionError("flash attention launched for a model with sliding layers")
    monkeypatch.setattr(FA, "flash_attention", refuse)


def test_mixed_model_greedy_generation_matches_jax(no_flash):
    """Two layers (sliding window 4, then full), a 12-token prompt with left
    padding, 16 greedy frames through the cache: codes and lengths equal
    JAX's; the prefill asked for flash and took the einsum path."""
    cfg = _sliding(tiny_test_config(), 4, ("sliding_attention", "full_attention"))
    jp, tp = _params(cfg)
    B, T = 2, 12
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.text_config.vocab_size - 8, size=(2 * B, T)).astype(np.int32)
    mask = np.ones((2 * B, T), np.int32)
    mask[0, :5] = 0
    prefill, steps = JD.prepare_audio_prompt(
        [None] * B, num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    want = generate_jit(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask), None, j_pad_buffer(prefill, MAX_TOKENS),
        jnp.asarray(steps, jnp.int32), jax.random.PRNGKey(0), max_tokens=MAX_TOKENS,
        min_tokens=jnp.int32(KNOBS["min_tokens"]), cfg_scale=jnp.float32(KNOBS["cfg_scale"]),
        temperature=jnp.float32(1.0), top_p=jnp.float32(1.0),
        cfg_filter_top_k=KNOBS["cfg_filter_top_k"], eos_prob_mul_factor=jnp.float32(1.0),
        do_sample=False)
    got = generate(tp, cfg, torch.tensor(ids), torch.tensor(mask), None,
                   pad_buffer(torch.tensor(np.asarray(prefill)), MAX_TOKENS), steps,
                   torch.Generator().manual_seed(0), max_tokens=MAX_TOKENS, do_sample=False,
                   **KNOBS)
    assert got.steps > 4                               # decode ran past the window
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    # The forward itself refuses flash for such a model, even when asked.
    tc = cfg.text_config
    emb = torch.randn(1, 8, tc.hidden_size)
    pos = torch.arange(8)[None, None].expand(3, 1, 8)
    TM.text_model_forward(tp, emb, pos, tc, use_flash=True)


def test_mixed_model_training_matches_jax(no_flash):
    """`loss_fn` of a 2-layer model with a sliding layer (window 5, codec and
    text labels, input jitter off): loss and gradients equal JAX's at
    `test_torch_train.py`'s tolerances, remat on."""
    cfg = _sliding(tiny_test_config(input_jitter_noise=0.0), 5,
                   ("full_attention", "sliding_attention"))
    jp, tp = _params(cfg)
    batch = _batch(cfg, seed=1, text_labels=True)
    (jloss, _), jgrads = jax.value_and_grad(JS.loss_fn, has_aux=True)(
        jp, cfg, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
        jnp.float32(0.025), remat=False)
    TS.init_train_state(tp, TS.make_optimizer())
    loss, _ = TS.loss_fn(tp, cfg, _tensors(batch), 0, 0.025, remat=True, use_flash=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _assert_tree_close(_grads(tp, loss), jax.tree.map(np.asarray, jgrads), GRAD_RTOL,
                       atol_rel=GRAD_ATOL_REL)


def test_sliding_layer_refuses_flash():
    cfg = _sliding(tiny_test_config(), 4, ("sliding_attention", "full_attention"))
    tc = cfg.text_config
    _, tp = _params(cfg)
    x = torch.randn(1, 8, tc.hidden_size)
    cos, sin = torch.ones(1, 8, tc.head_dim), torch.zeros(1, 8, tc.head_dim)
    with pytest.raises(ValueError, match="window"):
        TM.attention(tp["layers"][0]["attn"], x, cos, sin, tc, use_flash=True, is_sliding=True)
    assert TM.sliding_flags(tc, 2) == [True, False]
