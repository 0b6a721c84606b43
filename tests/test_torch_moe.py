"""DCMoE routing and the dense DCMoE block of the PyTorch port vs the JAX
package, f32 on the CPU: the router's masks and top-k counts exactly, its
weights at 1e-6 (constructed ties included), the block's output at 1e-5;
in training, the eval mixer's gradient and the block's gradients (hidden
states and every parameter) against jax.grad, and the input jitter."""

import dataclasses

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
from tests.torch_threads import one_torch_thread  # noqa: F401


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
    """ep dispatch runs without a mesh and equals dense (capacity S drops
    nothing); a8 in training, training jitter without a seed and the Gumbel
    mixer in training without a seed are errors, as in the JAX package (the
    mixer itself runs: tests/test_torch_train_core.py)."""
    cfg = tiny_test_config().text_config
    x = torch.zeros(1, 2, cfg.hidden_size)
    gen = torch.Generator().manual_seed(1)
    params = TB.init_dcmoe_params(gen, cfg, dtype=torch.float32, device="cpu")
    h = torch.randn(2, 6, cfg.hidden_size, generator=gen)
    torch.testing.assert_close(TB.dcmoe_block(params, h, cfg, dispatch_mode="ep").hidden_states,
                               TB.dcmoe_block(params, h, cfg).hidden_states,
                               rtol=1e-5, atol=1e-6)
    mixer = dataclasses.replace(cfg, ignore_differentiable_router=False, input_jitter_noise=0.0)
    for c, kw in ((cfg, {"training": True, "dispatch_mode": "dense_a8"}),
                  (cfg, {"training": True}), (mixer, {"training": True})):
        with pytest.raises(ValueError, match="seed|a8"):
            TB.dcmoe_block({"gate": torch.zeros(cfg.hidden_size, cfg.num_experts)}, x, c, **kw)


# Gradients in f32: the same arithmetic in another order.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_eval_mixer_gradient_matches_jax(seed):
    """d(Σ c · routing_weights)/d(scores) of the eval mixer equals JAX's,
    which stop-grads the permutation, the near-set and the shifts by v_r;
    the logits include exact ties, all-equal rows and near-ties."""
    dyn = _logits(seed)
    top_k = np.random.default_rng(seed).integers(1, dyn.shape[1] + 1, size=dyn.shape[0])
    c = np.random.default_rng(seed + 5).standard_normal(dyn.shape).astype(np.float32)
    import jax as _jax

    want = _jax.grad(lambda s: jnp.sum(JR.sparse_expert_mixer_eval(
        s, jnp.asarray(top_k, jnp.int32), jitter_eps=0.01)[0] * c))(jnp.asarray(dyn))
    t = torch.tensor(dyn, requires_grad=True)
    w, _ = TR.sparse_expert_mixer_eval(t, torch.tensor(top_k, dtype=torch.int32), jitter_eps=0.01)
    (w * torch.tensor(c)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert np.abs(np.asarray(want)).max() > 0


@pytest.mark.parametrize("with_abw", [False, True])
def test_dcmoe_training_grads_match_jax(with_abw):
    """dcmoe_block(training=True) with jitter eps 0 (f32 router, eval
    mixer, aux_balance_weight in the aux loss): the output, the aux loss and
    the gradients of Σ c · out + 3 · aux with respect to the hidden states
    and every parameter equal jax.grad's."""
    cfg = dataclasses.replace(tiny_test_config().text_config, input_jitter_noise=0.0)
    jp = JB.init_dcmoe_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, cfg.hidden_size)).astype(np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)
    pad = np.ones((2, 9), np.int32)
    pad[1, :2] = 0
    abw = (rng.uniform(size=(2, 9)) * 5).astype(np.float32) if with_abw else None

    def jloss(p, h):
        out = JB.dcmoe_block(p, h, cfg, padding_token_mask=jnp.asarray(pad),
                             aux_balance_weight=None if abw is None else jnp.asarray(abw),
                             training=True, dispatch_mode="dense")
        return jnp.sum(out.hidden_states * c) + 3.0 * out.aux_loss

    jv, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    leaves = [tp["gate"], *tp["dynamic"].values(), *tp["fixed"].values()]
    for t in leaves:
        t.requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    out = TB.dcmoe_block(tp, tx, cfg, padding_token_mask=torch.tensor(pad),
                         aux_balance_weight=None if abw is None else torch.tensor(abw),
                         training=True)
    loss = (out.hidden_states * torch.tensor(c)).sum() + 3.0 * out.aux_loss
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    want = [jgp["gate"], *jgp["dynamic"].values(), *jgp["fixed"].values()]
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert np.abs(np.asarray(jgp["gate"])).max() > 0


def test_input_jitter_range_and_seed():
    """Jitter samples lie in [1 - eps, 1 + eps] with mean about 1, and one
    seed draws one sample (what a recompute under remat relies on)."""
    a = TB.input_jitter((64, 512), 11, 0.01, torch.float32, "cpu")
    assert a.min() >= 0.99 and a.max() <= 1.01
    assert abs(a.mean().item() - 1.0) < 1e-4 and a.std().item() > 0.004
    assert torch.equal(a, TB.input_jitter((64, 512), 11, 0.01, torch.float32, "cpu"))
    assert not torch.equal(a, TB.input_jitter((64, 512), 12, 0.01, torch.float32, "cpu"))
