"""The training core of the PyTorch port vs the JAX package, f32 on the
CPU: the Gumbel / straight-through `sparse_expert_mixer` (value and gate
gradient with JAX's draws fed in; `training=False` against the closed-form
mixer; the port's own draws against JAX's by selection frequency) and the
DCMoE block with it; gradient accumulation (`Trainer` with
`grad_accum_steps=2` against JAX's `Trainer`, and a non-finite micro-step);
checkpoints and resume (k + k steps bit-equal to 2k, pruning and sidecars);
and `save_pretrained` both ways (the port's export served greedily by both
packages' loaders, the JAX package's export loaded by the port).  Input
jitter is off wherever the two frameworks are compared (they draw different
noise).  Everything is f32, where XLA's fusions round as the port does, so
the JAX side runs jitted."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.generate.loop import generate_jit, pad_buffer as j_pad_buffer
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.moe import block as JB
from unimoe_audio_tpu.moe import router as JR
from unimoe_audio_tpu.train.trainer import Trainer as JTrainer
from unimoe_audio_tpu.train.trainer import TrainerConfig as JTrainerConfig
from unimoe_audio_torch.api import UniMoEAudio
from unimoe_audio_torch.codec import delay as TDL
from unimoe_audio_torch.core import checkpoint as CK
from unimoe_audio_torch.core.bridge import params_from_jax, params_to_numpy
from unimoe_audio_torch.generate.loop import generate, pad_buffer
from unimoe_audio_torch.moe import block as TB
from unimoe_audio_torch.moe import router as TR
from unimoe_audio_torch.train import step as TS
from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig

# The mixer in f32, the same operations in the same order: value and
# gradient at rtol 1e-6 (an absolute floor of 1e-6 of the largest entry).
MIX_RTOL = 1e-6
# Block outputs and trained parameters: f32 in another summation order (the
# tolerances of tests/test_torch_train.py).
BLOCK_RTOL, BLOCK_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config(input_jitter_noise=0.0)
    jp = JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return cfg, jp, jax.tree.map(np.asarray, jp)


def _torch_params(cfg, tree):
    return params_from_jax(tree, cfg, "cpu", torch.float32)


def _batch(cfg, seed, B=2, T=24):
    rng = np.random.default_rng(seed)
    C = cfg.codec_channels
    ids = rng.integers(0, cfg.text_config.vocab_size - 8, size=(B, T)).astype(np.int32)
    ids[:, 5:] = cfg.codec_placeholder_value
    mask = np.ones((B, T), np.int32)
    mask[1, :3] = 0
    codec = rng.integers(0, cfg.codec_eos_value, size=(B, T, C)).astype(np.int32)
    lab = codec.copy()
    lab[:, :6] = -100
    return {"input_ids": ids, "codec_input_ids": codec, "attention_mask": mask,
            "codec_labels": lab,
            "aux_balance_weight": np.where(lab[..., 0] != -100, 10.0, 1.0).astype(np.float32)}


def _jax_draws(key, S, E):
    """JAX's training-mixer draws for `key` (`router.py:99-101, 129, 138`):
    one key per round, Gumbel noise [E, S, E] and the coins [E, S]."""
    def draws(key):
        keys = jax.random.split(key, E)
        return (jax.vmap(lambda k: jax.random.gumbel(k, (S, E), jnp.float32))(keys),
                jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 1), (S,)))(keys))

    gumbel, coin = jax.jit(draws)(key)
    return torch.tensor(np.asarray(gumbel)), torch.tensor(np.asarray(coin))


def _close(got, want, rtol, floor=None):
    want = np.asarray(want)
    atol = (floor or rtol) * max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("eps", [0.01, 0.3])
def test_mixer_training_matches_jax_with_its_draws(eps):
    """The training mixer with JAX's Gumbel noise and coins fed in: routing
    weights (the straight-through values m·c), the expert mask and the
    gradient through the gates, against JAX's `sparse_expert_mixer(
    training=True)`; a tie between two scores, top_k 1 to E."""
    S, E = 96, 9
    rng = np.random.default_rng(int(eps * 100))
    scores = rng.standard_normal((S, E)).astype(np.float32)
    scores[3, 2] = scores[3, 5]
    top_k = rng.integers(1, E + 1, size=S).astype(np.int32)
    g = rng.standard_normal((S, E)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def jf(sc):
        r = JR.sparse_expert_mixer(sc, jnp.asarray(top_k), max_k=E, jitter_eps=eps,
                                   training=True, rng=key)
        return jnp.sum(r.routing_weights * g), r

    (_, jr), jgrad = jax.jit(jax.value_and_grad(jf, has_aux=True))(jnp.asarray(scores))
    ts = torch.tensor(scores, requires_grad=True)
    tr = TR.sparse_expert_mixer(ts, torch.tensor(top_k), max_k=E, jitter_eps=eps,
                                training=True, draws=_jax_draws(key, S, E))
    (tr.routing_weights * torch.tensor(g)).sum().backward()
    np.testing.assert_array_equal(tr.expert_mask.numpy(), np.asarray(jr.expert_mask))
    _close(tr.routing_weights.detach().numpy(), jr.routing_weights, MIX_RTOL)
    _close(ts.grad.numpy(), jgrad, MIX_RTOL)
    # The straight-through scaling took both values somewhere.
    w = tr.routing_weights.detach().numpy()
    assert (tr.expert_mask.numpy().sum(-1) == top_k).all() and (w > 0).sum() == top_k.sum()


def test_mixer_eval_matches_closed_form_jax():
    """`sparse_expert_mixer(training=False)` against JAX's closed-form
    `sparse_expert_mixer_eval` and JAX's scan (jitted: no straight-through
    rounding here), value and gradient."""
    S, E = 64, 9
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((S, E)).astype(np.float32)
    scores[5, 1] = scores[5, 4]
    top_k = rng.integers(1, E + 1, size=S).astype(np.int32)
    g = rng.standard_normal((S, E)).astype(np.float32)

    def jf(sc):
        r = JR.sparse_expert_mixer_eval(sc, jnp.asarray(top_k), jitter_eps=0.01)
        return jnp.sum(r.routing_weights * g), r

    (_, jr), jgrad = jax.jit(jax.value_and_grad(jf, has_aux=True))(jnp.asarray(scores))
    scan = JR.sparse_expert_mixer(jnp.asarray(scores), jnp.asarray(top_k), max_k=E,
                                  jitter_eps=0.01)
    ts = torch.tensor(scores, requires_grad=True)
    tr = TR.sparse_expert_mixer(ts, torch.tensor(top_k), max_k=E, jitter_eps=0.01)
    (tr.routing_weights * torch.tensor(g)).sum().backward()
    for want in (jr, scan):
        np.testing.assert_array_equal(tr.expert_mask.numpy(), np.asarray(want.expert_mask))
        _close(tr.routing_weights.detach().numpy(), want.routing_weights, MIX_RTOL)
    _close(ts.grad.numpy(), jgrad, MIX_RTOL)


def test_mixer_own_draws_match_jax_by_frequency():
    """The port's own draws (a seeded torch.Generator) against JAX's by
    distribution, on S = 4,000 tokens of one score row, top_k 1: the
    selected expert, and whether the straight-through value is whole
    (mask_for_one 1) or scaled by 0.3333; a two-sample chi-square test each
    (p > 1e-3).  The same seed draws the same, another seed otherwise."""
    from scipy.stats import chi2_contingency

    S, E, eps = 4000, 9, 0.3
    row = np.array([1.2, 0.9, 0.7, 0.5, 0.2, 0.0, -0.4, 0.8, 1.0], np.float32)
    scores, top_k = np.tile(row, (S, 1)), np.ones(S, np.int32)
    jr = JR.sparse_expert_mixer(jnp.asarray(scores), jnp.asarray(top_k), max_k=E,
                                jitter_eps=eps, training=True, rng=jax.random.PRNGKey(11))

    def port(seed):
        return TR.sparse_expert_mixer(torch.tensor(scores), torch.tensor(top_k), max_k=E,
                                      jitter_eps=eps, training=True, seed=seed)

    tr = port(11)
    results = [(np.asarray(jr.routing_weights), np.asarray(jr.expert_mask)),
               (tr.routing_weights.numpy(), tr.expert_mask.numpy())]
    counts = np.stack([m.sum(0) for _, m in results])
    live = counts.sum(0) > 0
    assert live.sum() >= 3                      # several experts inside the threshold
    assert chi2_contingency(counts[:, live])[1] > 1e-3
    # The first round's softmax over the experts inside the threshold.
    near = ~(((row.max() - row) / np.maximum(np.abs(row), abs(row.max()))) > 2 * eps)
    p = np.exp(row - row.max()) * near
    p /= p.sum()
    whole = []
    for w, m in results:
        sel = m.argmax(-1)
        got = w[np.arange(S), sel]
        is_whole = np.isclose(got, p[sel], rtol=1e-4)
        assert (is_whole | np.isclose(got, 0.3333 * p[sel], rtol=1e-4)).all()
        whole.append(int(is_whole.sum()))
    assert 0 < min(whole) and max(whole) < S
    assert chi2_contingency(np.array([[w, S - w] for w in whole]))[1] > 1e-3
    assert torch.equal(port(11).expert_mask, tr.expert_mask)
    assert not torch.equal(port(12).expert_mask, tr.expert_mask)


def test_dcmoe_block_with_mixer_matches_jax(setup):
    """The DCMoE block in training with ignore_differentiable_router=False
    (the mixer's draws fed in from JAX's rng split, `block.py:113-123`) vs
    JAX's `dcmoe_block`: output, aux loss and the gradients of the input and
    the router weight."""
    cfg, jp, tree = setup
    tc = dataclasses.replace(cfg.text_config, ignore_differentiable_router=False)
    B, T, D = 2, 12, tc.hidden_size
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    pad = np.ones((B, T), np.int32)
    pad[1, :4] = 0
    g = rng.standard_normal((B, T, D)).astype(np.float32)
    jmoe = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    key = jax.random.PRNGKey(4)

    def jf(moe, xx):
        out = JB.dcmoe_block(moe, xx, tc, padding_token_mask=jnp.asarray(pad), training=True,
                             rng=key)
        return jnp.sum(out.hidden_states * g) + out.aux_loss, out

    (_, jout), (jg_moe, jg_x) = jax.jit(jax.value_and_grad(jf, argnums=(0, 1), has_aux=True))(
        jmoe, jnp.asarray(x))
    draws = _jax_draws(jax.random.split(key)[1], B * T, tc.num_dynamic_experts)
    moe = _torch_params(cfg, tree)["layers"][0]["moe"]
    moe["gate"].requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    out = TB.dcmoe_block(moe, tx, tc, padding_token_mask=torch.tensor(pad), training=True,
                         mixer_draws=draws)
    ((out.hidden_states * torch.tensor(g)).sum() + out.aux_loss).backward()
    np.testing.assert_array_equal(out.expert_mask.numpy(), np.asarray(jout.expert_mask))
    np.testing.assert_allclose(out.hidden_states.detach().numpy(), np.asarray(jout.hidden_states),
                               rtol=BLOCK_RTOL, atol=BLOCK_ATOL)
    np.testing.assert_allclose(out.aux_loss.item(), float(jout.aux_loss), rtol=BLOCK_RTOL)
    for got, want in ((tx.grad, jg_x), (moe["gate"].grad, jg_moe["gate"])):
        _close(got.numpy(), want, 1e-4, floor=1e-5)


def test_trainer_with_mixer_draws_from_the_step_seed(setup):
    """Training with the Gumbel mixer on through `loss_fn`: remat on and off
    give the same loss and gradients (the recompute draws what the forward
    drew, from the seed); another step seed draws otherwise."""
    cfg, _, tree = setup
    cfg = dataclasses.replace(cfg, text_config=dataclasses.replace(
        cfg.text_config, ignore_differentiable_router=False))
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg, seed=8).items()}
    out = {}
    for remat in (False, True):
        params = _torch_params(cfg, tree)
        TS.init_train_state(params, TS.make_optimizer())
        loss, m = TS.loss_fn(params, cfg, batch, 3, 0.025, remat=remat)
        leaves = [t for _, t in TS.named_leaves(params)]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out[remat] = (loss.item(), [g for g in grads if g is not None])
    assert np.isfinite(out[False][0]) and out[True][0] == out[False][0]
    assert all(torch.equal(a, b) for a, b in zip(out[True][1], out[False][1]))
    with torch.no_grad():
        other, _ = TS.loss_fn(_torch_params(cfg, tree), cfg, batch, 4, 0.025, remat=False)
    assert other.item() != out[False][0]


def _assert_params_close(got, want, lr_sum):
    """As tests/test_torch_train.py: the k_proj bias (a gradient of rounding
    noise that Adam turns into steps of up to lr) held to 2 · Σ lr."""
    got = jax.tree.map(np.asarray, got)
    want = jax.tree.map(np.asarray, want)
    kb_got = got["layers"]["attn"]["k_proj"].pop("b")
    kb_want = want["layers"]["attn"]["k_proj"].pop("b")
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(kb_got, kb_want, rtol=0, atol=2 * lr_sum + PARAM_ATOL)


def test_grad_accum_trainer_matches_jax(setup, tmp_path):
    """`Trainer(TrainerConfig(ckpt_dir, save_every, grad_accum_steps=2))`
    for 4 micro-steps on 4 batches vs the JAX `Trainer` with
    grad_accum_steps=2 (optax.MultiSteps): every micro-step's metrics, the
    final parameters, the micro-step count; the parameters stay put after
    the first micro-step; checkpoints at steps 3 and 4 hold the
    accumulator."""
    cfg, jp, tree = setup
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=8, log_every=1, remat=False,
              grad_accum_steps=2)
    batches = [_batch(cfg, seed=40 + i) for i in range(4)]
    jtr = JTrainer(cfg, jax.tree.map(jnp.array, jp), JTrainerConfig(**kw))
    jhist = jtr.fit(batches)
    ttr = Trainer(cfg, _torch_params(cfg, tree),
                  TrainerConfig(**kw, ckpt_dir=str(tmp_path), save_every=2), device="cpu")
    first = ttr.fit(batches[:1])
    assert ttr.state.step == 1 and ttr.state.opt_state.mini_step == 1
    assert ttr.state.opt_state.count == 0
    np.testing.assert_array_equal(params_to_numpy(ttr.state.params)["layers"]["moe"]["gate"],
                                  tree["layers"]["moe"]["gate"])
    thist = first + ttr.fit(batches[1:])
    assert len(thist) == len(jhist) == 4
    for t, j in zip(thist, jhist):
        assert t["step"] == j["step"]
        for k in ("loss", "codec_loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(t[k], j[k], rtol=LOSS_RTOL, err_msg=k)
    assert ttr.state.step == int(jtr.state.step) == 4 and ttr.state.opt_state.count == 2
    _assert_params_close(params_to_numpy(ttr.state.params), jtr.state.params,
                         sum(TS.make_lr_schedule(1e-3, 1, 8)(i) for i in range(2)))
    assert CK.all_steps(str(tmp_path)) == [1, 3, 4]


def test_nonfinite_micro_step_keeps_the_accumulator(setup):
    """tests/test_train3.py:281 in the port: a non-finite micro-step between
    two good ones leaves the accumulator, the moments, the mini-step, the
    update count and the step count as they were, and the pair it
    completes gives the parameters of the same two good micro-steps run
    alone, bit for bit."""
    cfg, _, tree = setup
    good = {k: torch.as_tensor(v) for k, v in _batch(cfg, seed=50).items()}
    bad = dict(good)
    emb = torch.zeros(*good["input_ids"].shape, cfg.text_config.hidden_size)
    emb[0, 0, 0] = float("nan")
    bad["inputs_embeds"] = emb
    runs = []
    for seq in ((good, bad, good), (good, good)):
        opt = TS.make_optimizer(learning_rate=1e-3, warmup_steps=0, total_steps=8,
                                grad_accum_steps=2)
        st = TS.init_train_state(_torch_params(cfg, tree), opt)
        for i, b in enumerate(seq):
            snap = ([a.clone() for a in st.opt_state.acc], [m.clone() for m in st.opt_state.mu],
                    st.opt_state.mini_step, st.opt_state.count, st.step)
            st, m = TS.train_step(st, b, 0, cfg=cfg, optimizer=opt, remat=False)
            if b is bad:
                assert m["skipped"].item() == 1
                assert all(torch.equal(a, b) for a, b in zip(st.opt_state.acc, snap[0]))
                assert all(torch.equal(a, b) for a, b in zip(st.opt_state.mu, snap[1]))
                assert (st.opt_state.mini_step, st.opt_state.count, st.step) == snap[2:]
        assert st.step == 2 and st.opt_state.count == 1 and st.opt_state.mini_step == 0
        assert all(not a.any() for a in st.opt_state.acc)
        runs.append(params_to_numpy(st.params))
    for a, b in zip(jax.tree.leaves(runs[0]), jax.tree.leaves(runs[1])):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(runs[0]["layers"]["moe"]["gate"], tree["layers"]["moe"]["gate"])


@pytest.mark.parametrize("accum", [1, 2])
def test_resume_is_bit_equal_to_an_uninterrupted_run(setup, tmp_path, accum):
    """k steps, a save, a new Trainer that resumes, k more steps: the
    losses of the resumed steps, the parameters, the moments, the
    accumulator and the counters equal those of 2k steps run straight
    through, bit for bit (with grad_accum_steps 2 the save falls between
    the two micro-steps of an update).  save_every 1 with max_to_keep 2
    keeps the two newest steps."""
    cfg, _, tree = setup
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=8, log_every=1, remat=False,
              grad_accum_steps=accum)
    batches = [_batch(cfg, seed=60 + i) for i in range(4)]
    ref = Trainer(cfg, _torch_params(cfg, tree), TrainerConfig(**kw), device="cpu")
    want = ref.fit(batches)
    ck = dict(ckpt_dir=str(tmp_path), save_every=1, max_to_keep=2)
    first = Trainer(cfg, _torch_params(cfg, tree), TrainerConfig(**kw, **ck), device="cpu")
    first.fit(batches[:3])
    assert CK.all_steps(str(tmp_path)) == [2, 3]
    fresh = Trainer(cfg, _torch_params(cfg, tree), TrainerConfig(**kw, **ck), device="cpu")
    got = fresh.fit(batches[3:], max_steps=4)
    assert [h["step"] for h in got] == [3] and got[0]["loss"] == want[3]["loss"]
    a, b = fresh.state, ref.state
    assert (a.step, a.opt_state.count, a.opt_state.mini_step) == \
        (b.step, b.opt_state.count, b.opt_state.mini_step) == (4, 4 // accum, 0)
    for x, y in zip(TS.named_leaves(a.params), TS.named_leaves(b.params)):
        assert x[1].requires_grad and torch.equal(x[1], y[1]), x[0]
    for xs, ys in ((a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu),
                   (a.opt_state.acc or [], b.opt_state.acc or [])):
        assert all(torch.equal(x, y) for x, y in zip(xs, ys))
    assert CK.all_steps(str(tmp_path)) == [3, 4]
    assert fresh.fit(batches[3:], max_steps=4) == []     # nothing left to run


def test_checkpoint_prunes_steps_and_sidecars(tmp_path):
    """save_checkpoint keeps the max_to_keep newest steps and their
    metadata sidecars, skips a step at or below the newest, and never
    leaves a temporary directory; restore checks the leaves."""
    params = {"w": torch.randn(3, 4), "layers": [{"b": torch.randn(4)}, {"b": torch.randn(4)}]}
    opt = TS.make_optimizer(grad_accum_steps=2)
    state = TS.init_train_state(params, opt)
    d = str(tmp_path / "ck")
    saved = {}
    for step in (1, 2, 3, 4):
        state.step = step
        with torch.no_grad():
            params["w"].add_(1.0)
        saved[step] = params["w"].detach().clone()
        assert CK.save_checkpoint(d, step, state, metadata={"step": step}, max_to_keep=2)
    assert not CK.save_checkpoint(d, 3, state, max_to_keep=2)
    assert CK.all_steps(d) == [3, 4] and CK.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["3", "4", "meta_3.json", "meta_4.json"]
    other = {"w": torch.zeros(3, 4), "layers": [{"b": torch.zeros(4)}, {"b": torch.zeros(4)}]}
    back = CK.restore_checkpoint(d, TS.init_train_state(other, opt), step=3)
    assert back.step == 3 and torch.equal(other["w"], saved[3]) and other["w"].requires_grad
    with pytest.raises(ValueError):
        CK.restore_checkpoint(d, TS.init_train_state({"w": torch.zeros(3, 4)}, opt))
    assert CK.latest_step(str(tmp_path / "none")) is None


GREEDY = dict(min_tokens=4, cfg_scale=3.0, temperature=1.0, top_p=1.0, cfg_filter_top_k=16,
              eos_prob_mul_factor=1.0)


def _greedy_both(cfg, jparams, tparams, max_tokens=10):
    """Greedy codes of the JAX loop over jparams and of the port's loop over
    tparams, on the same 2 CFG rows of 16 tokens."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.text_config.vocab_size - 8, size=(2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[0, :3] = 0
    prefill, steps = TDL.prepare_audio_prompt([None], num_channels=cfg.codec_channels,
                                              bos_value=cfg.codec_bos_value,
                                              delay_pattern=cfg.codec_delay_pattern)
    prefill = np.asarray(prefill)
    want = generate_jit(
        jparams, cfg, jnp.asarray(ids), jnp.asarray(mask), None,
        j_pad_buffer(prefill, max_tokens), jnp.asarray(steps, jnp.int32), jax.random.PRNGKey(0),
        max_tokens=max_tokens, min_tokens=jnp.int32(GREEDY["min_tokens"]),
        cfg_scale=jnp.float32(GREEDY["cfg_scale"]), temperature=jnp.float32(1.0),
        top_p=jnp.float32(1.0), cfg_filter_top_k=GREEDY["cfg_filter_top_k"],
        eos_prob_mul_factor=jnp.float32(1.0), do_sample=False)
    got = generate(tparams, cfg, torch.tensor(ids), torch.tensor(mask), None,
                   pad_buffer(torch.tensor(prefill), max_tokens), steps, torch.Generator(),
                   max_tokens=max_tokens, do_sample=False, **GREEDY)
    return np.asarray(want.codes), got.codes.numpy()


def test_save_pretrained_both_ways(setup, tmp_path):
    """The port's export after a training step: `model.jax.pkl` (numpy
    leaves only) + `config.json`; the port's `UniMoEAudio` loads the
    trainer's parameters bit for bit, JAX's loads them too, and greedy
    decoding over the two loads gives equal codes.  Then the JAX package's
    export loads into the port with the JAX trainer's parameters."""
    import pickle

    from unimoe_audio_tpu.api import UniMoEAudio as JUniMoEAudio

    cfg, jp, tree = setup
    ttr = Trainer(cfg, _torch_params(cfg, tree), TrainerConfig(
        learning_rate=1e-3, warmup_steps=0, total_steps=4, remat=False), device="cpu")
    ttr.fit([_batch(cfg, seed=70)])
    out = str(tmp_path / "port_export")
    ttr.save_pretrained(out)
    assert sorted(os.listdir(out)) == ["config.json", "model.jax.pkl"]
    with open(os.path.join(out, "model.jax.pkl"), "rb") as f:
        blob = pickle.load(f)
    assert all(isinstance(a, np.ndarray) for a in jax.tree.leaves(blob["params"]))
    tm = UniMoEAudio(out, dtype=torch.float32, device="cpu")
    for x, y in zip(TS.named_leaves(tm.params), TS.named_leaves(ttr.state.params)):
        assert x[0] == y[0] and torch.equal(x[1], y[1].detach()), x[0]
    jm = JUniMoEAudio(out, dtype=jnp.float32, tokenizer=object())
    want, got = _greedy_both(cfg, jm.params, tm.params)
    np.testing.assert_array_equal(got, want)

    jtr = JTrainer(cfg, jax.tree.map(jnp.array, jp), JTrainerConfig(
        learning_rate=1e-3, warmup_steps=0, total_steps=4, remat=False))
    jtr.fit([_batch(cfg, seed=70)])
    jout = str(tmp_path / "jax_export")
    jtr.save_pretrained(jout)
    tm2 = UniMoEAudio(jout, dtype=torch.float32, device="cpu")
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(params_to_numpy(tm2.params))[0],
            jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jtr.state.params))[0]):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
