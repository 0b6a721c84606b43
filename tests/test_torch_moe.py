"""DCMoE routing and the dense DCMoE block of the PyTorch port vs the JAX
package, f32 on the CPU: the router's masks and top-k counts exactly, its
weights at 1e-6 (constructed ties included), the block's output at 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.moe import block as JB
from unimoe_audio_tpu.moe import router as JR
from unimoe_audio_torch.core.bridge import to_torch
from unimoe_audio_torch.moe import block as TB
from unimoe_audio_torch.moe import router as TR


def _logits(seed, S=64, E=9):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((S, E)).astype(np.float32) * 2
    # Constructed ties: exact duplicates, an all-equal row, zeros (0/0 in
    # the mixer's relative threshold), and near-ties inside 2·jitter_eps.
    x[0, 3] = x[0, 5] = x[0, 1]
    x[1, :] = 0.7
    x[2, :4] = 0.0
    x[3, 2] = x[3, 6] * (1 + 0.005)
    x[4, :] = np.array([1.0, 1.0, 0.99, 0.5, 0.5, 0.5, -2.0, -2.0, 3.0], np.float32)[:E]
    return x


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("top_p", [0.7, 0.95])
def test_router_functions_match(seed, top_p):
    dyn = _logits(seed)
    full = np.concatenate([dyn, np.random.default_rng(seed + 9).standard_normal(
        (dyn.shape[0], 2)).astype(np.float32)], -1)
    jk = JR.dynamic_expert_selection(jnp.asarray(dyn), top_p)
    tk = TR.dynamic_expert_selection(torch.tensor(dyn), top_p)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert tk.dtype == torch.int32

    jw, jm = JR.sparse_expert_mixer_eval(jnp.asarray(dyn), jk, jitter_eps=0.01)
    tw, tm = TR.sparse_expert_mixer_eval(torch.tensor(dyn), tk, jitter_eps=0.01)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)

    mask = np.concatenate([np.asarray(jm), np.ones((dyn.shape[0], 2), np.int32)], -1)
    jg = JR.global_routing_weight(jnp.asarray(mask), jnp.asarray(full), 9, jw)
    tg = TR.global_routing_weight(torch.tensor(mask), torch.tensor(full), 9, tw)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)

    abw = np.random.default_rng(seed).uniform(size=dyn.shape[0]).astype(np.float32)
    for w in (None, abw):
        jl = JR.load_balancing_loss(jnp.asarray(mask), jnp.asarray(full), 9,
                                    None if w is None else jnp.asarray(w))
        tl = TR.load_balancing_loss(torch.tensor(mask), torch.tensor(full), 9,
                                    None if w is None else torch.tensor(w))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6, atol=1e-6)


def test_mixer_tie_break_is_index_order():
    """Equal scores are ranked by expert index: with top_k = 1 the lowest
    index among the tied maxima is the one selected."""
    dyn = np.zeros((1, 5), np.float32)
    dyn[0, [1, 3]] = 2.0
    _, tm = TR.sparse_expert_mixer_eval(torch.tensor(dyn), torch.tensor([1]), jitter_eps=0.01)
    assert tm.numpy().tolist() == [[0, 1, 0, 0, 0]]


def test_dcmoe_block_dense_matches():
    cfg = tiny_test_config().text_config
    jp = JB.init_dcmoe_params(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, cfg.hidden_size)).astype(np.float32)
    pad = np.ones((2, 7), np.int32)
    pad[0, :3] = 0
    want = JB.dcmoe_block(jp, jnp.asarray(x), cfg, padding_token_mask=jnp.asarray(pad),
                          dispatch_mode="dense")
    got = TB.dcmoe_block(tp, torch.tensor(x), cfg, padding_token_mask=torch.tensor(pad))
    np.testing.assert_allclose(got.hidden_states.numpy(), np.asarray(want.hidden_states),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.expert_mask.numpy(), np.asarray(want.expert_mask))
    np.testing.assert_array_equal(got.router_top_k.numpy(), np.asarray(want.router_top_k))
    np.testing.assert_allclose(got.router_weight.numpy(), np.asarray(want.router_weight),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.aux_loss.item(), float(want.aux_loss), rtol=1e-5)


def test_dcmoe_block_unported_modes_raise():
    cfg = tiny_test_config().text_config
    x = torch.zeros(1, 2, cfg.hidden_size)
    for kw in ({"training": True}, {"dispatch_mode": "packed"}, {"dispatch_mode": "dense_a8"}):
        with pytest.raises(NotImplementedError):
            TB.dcmoe_block({}, x, cfg, **kw)
