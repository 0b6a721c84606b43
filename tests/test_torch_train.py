"""The training slice of the PyTorch port vs the JAX package, f32 on the
CPU: `loss_fn` values and gradients (codec labels with holes, the text-label
path, remat on and off, the packed and gmm dispatch modes), three
`train_step`s against optax (parameters and every metric, with and without
`trainable_pattern`), the lr schedule, the
skip of a non-finite step, `Trainer.fit` (dense and gmm), the `Collator` and the bridge back
to the JAX layout.  Input jitter is off wherever the two are compared (the
two frameworks draw different random numbers); remat with jitter on is held
against remat off in the port alone."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.train import data as JD
from unimoe_audio_tpu.train import step as JS
from unimoe_audio_tpu.train.trainer import Trainer as JTrainer
from unimoe_audio_tpu.train.trainer import TrainerConfig as JTrainerConfig
from unimoe_audio_torch.core.bridge import params_from_jax, params_to_numpy
from unimoe_audio_torch.train import data as TD
from unimoe_audio_torch.train import step as TS
from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig
from tests.torch_threads import one_torch_thread  # noqa: F401

# f32 on both sides, the same arithmetic in another order: losses at 1e-5;
# gradients and trained parameters at rtol 1e-4 with an absolute floor of
# 1e-4 of the leaf's largest magnitude (1e-6 for parameters).
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config(input_jitter_noise=0.0)
    jp = JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return cfg, jp, tree


def _torch_params(cfg, tree):
    return params_from_jax(tree, cfg, "cpu", torch.float32)


def _batch(cfg, seed, text_labels=False, B=2, T=24):
    """Codec-placeholder rows after a text prefix, one left-padded row,
    codec labels with -100 holes, an aux_balance_weight; optionally text
    labels on the prefix."""
    rng = np.random.default_rng(seed)
    C = cfg.codec_channels
    ids = rng.integers(0, cfg.text_config.vocab_size - 8, size=(B, T)).astype(np.int32)
    ids[:, 5:] = cfg.codec_placeholder_value
    mask = np.ones((B, T), np.int32)
    mask[1, :3] = 0
    codec = rng.integers(0, cfg.codec_eos_value, size=(B, T, C)).astype(np.int32)
    lab = codec.copy()
    lab[:, :6] = -100
    lab[0, 10:12, 1] = -100
    lab[1, :, C - 1] = -100                     # one channel with no label in a row
    batch = {"input_ids": ids, "codec_input_ids": codec, "attention_mask": mask,
             "codec_labels": lab,
             "aux_balance_weight": np.where(lab[..., 0] != -100, 10.0, 1.0).astype(np.float32)}
    if text_labels:
        tl = np.where(np.arange(T)[None] < 6, ids, -100).astype(np.int32)
        tl[1, :3] = -100
        batch["labels"] = tl
    return batch


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _grads(params, loss):
    leaves = [t for _, t in TS.named_leaves(params)]
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [rebuild(v) for v in tree]
        g = next(grads)
        return torch.zeros_like(tree) if g is None else g
    return params_to_numpy(rebuild(params))


def _assert_tree_close(got, want, rtol, atol_rel=None, atol=None):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        w = np.asarray(flat_w[path])
        tol = atol if atol is not None else atol_rel * max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def _assert_params_close(got, want, lr_sum):
    """Trained parameters at PARAM_RTOL / PARAM_ATOL, except the k_proj
    bias: softmax is invariant to a per-query shift of the scores, so its
    gradient is zero up to rounding, and Adam turns that noise into steps
    of up to the learning rate in either framework.  It is held to
    2 · Σ lr instead."""
    got = jax.tree.map(np.asarray, got)
    want = jax.tree.map(np.asarray, want)
    kb_got = got["layers"]["attn"]["k_proj"].pop("b")
    kb_want = want["layers"]["attn"]["k_proj"].pop("b")
    _assert_tree_close(got, want, PARAM_RTOL, atol=PARAM_ATOL)
    np.testing.assert_allclose(kb_got, kb_want, rtol=0, atol=2 * lr_sum + PARAM_ATOL)


_JAX_LOSS = {}


def _jax_loss_and_grads(jp, cfg, batch, key, **kw):
    if key not in _JAX_LOSS:
        (loss, metrics), grads = jax.value_and_grad(JS.loss_fn, has_aux=True)(
            jp, cfg, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0),
            jnp.float32(0.025), remat=False, **kw)
        _JAX_LOSS[key] = (float(loss), {k: float(v) for k, v in metrics.items()},
                          jax.tree.map(np.asarray, grads))
    return _JAX_LOSS[key]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("text_labels", [False, True])
def test_loss_fn_matches_jax(setup, text_labels, remat):
    cfg, jp, tree = setup
    batch = _batch(cfg, seed=1, text_labels=text_labels)
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jp, cfg, batch, text_labels)
    params = _torch_params(cfg, tree)
    TS.init_train_state(params, TS.make_optimizer())
    loss, metrics = TS.loss_fn(params, cfg, _tensors(batch), 0, 0.025, remat=remat)
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=LOSS_RTOL, err_msg=k)
    _assert_tree_close(_grads(params, loss), jgrads, GRAD_RTOL, atol_rel=GRAD_ATOL_REL)


@pytest.mark.parametrize("mode,capacity", [("packed", 20), ("gmm", None)])
def test_loss_fn_dispatch_modes_match_jax(setup, mode, capacity):
    """`loss_fn` through the packed (capacity 20 of 48 tokens: tokens are
    dropped) and gmm dispatch modes, remat on, vs JAX's (megablox in
    interpret mode): loss, metrics and gradients at the tolerances above."""
    cfg, jp, tree = setup
    batch = _batch(cfg, seed=1, text_labels=True)
    jloss, jmetrics, jgrads = _jax_loss_and_grads(jp, cfg, batch, (mode, capacity),
                                                  dispatch_mode=mode, capacity=capacity)
    params = _torch_params(cfg, tree)
    TS.init_train_state(params, TS.make_optimizer())
    loss, metrics = TS.loss_fn(params, cfg, _tensors(batch), 0, 0.025, dispatch_mode=mode,
                               capacity=capacity, remat=True)
    np.testing.assert_allclose(loss.item(), jloss, rtol=LOSS_RTOL)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].item(), v, rtol=LOSS_RTOL, err_msg=k)
    _assert_tree_close(_grads(params, loss), jgrads, GRAD_RTOL, atol_rel=GRAD_ATOL_REL)


def test_remat_grads_equal_without_remat_with_jitter_on(setup):
    """With input jitter on, each layer's noise comes from its own seed, so
    the recompute under remat draws the same noise: gradients with remat on
    equal those with remat off.  Another seed gives another loss."""
    cfg, _, tree = setup
    cfg = dataclasses.replace(cfg, text_config=dataclasses.replace(
        cfg.text_config, input_jitter_noise=0.05))
    batch = _tensors(_batch(cfg, seed=2))
    out = {}
    for remat in (False, True):
        params = _torch_params(cfg, tree)
        TS.init_train_state(params, TS.make_optimizer())
        loss, _ = TS.loss_fn(params, cfg, batch, 7, 0.025, remat=remat)
        out[remat] = (loss.item(), _grads(params, loss))
    assert out[False][0] == pytest.approx(out[True][0], rel=1e-6)
    _assert_tree_close(out[True][1], out[False][1], 1e-6, atol_rel=1e-6)
    with torch.no_grad():
        other, _ = TS.loss_fn(_torch_params(cfg, tree), cfg, batch, 8, 0.025, remat=False)
    assert abs(other.item() - out[False][0]) > 1e-6


def test_flash_route_grads_match_einsum_route(setup):
    """The training path through the flash attention function (its plain
    version on the CPU, with the hand-written backward) gives the loss and
    gradients of the einsum attention path (no padding: the two differ only
    on fully padded query rows)."""
    cfg, _, tree = setup
    batch = _batch(cfg, seed=3)
    batch["attention_mask"][:] = 1
    batch = _tensors(batch)
    out = []
    for flash in (False, True):
        params = _torch_params(cfg, tree)
        TS.init_train_state(params, TS.make_optimizer())
        loss, _ = TS.loss_fn(params, cfg, batch, 0, 0.025, remat=True, use_flash=flash)
        out.append((loss.item(), _grads(params, loss)))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-6)
    _assert_tree_close(out[1][1], out[0][1], GRAD_RTOL, atol_rel=GRAD_ATOL_REL)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_lr_schedule_matches_optax(schedule):
    for warmup, total in ((1, 100), (2, 10), (0, 5)):
        want = JS.make_lr_schedule(1e-3, warmup, total, schedule)
        got = TS.make_lr_schedule(1e-3, warmup, total, schedule)
        for step in list(range(6)) + [total - 1, total + 3]:
            # optax evaluates in f32: 1e-6 of the peak rate absolute.
            np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-9)
    assert TS.make_lr_schedule(1e-3, 1, 100)(0) == 0.0


def test_param_names_match_the_stacked_tree(setup):
    """The names the decay mask and trainable_pattern see are the JAX
    package's stacked-tree paths (no layer index)."""
    cfg, _, tree = setup
    want = sorted("/".join(str(p.key) for p in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0])
    got = sorted(n for n, _ in TS.named_leaves(_torch_params(cfg, tree)))
    per_layer = {n for n in got if n.startswith("layers/")}
    assert sorted(set(got)) == want and len(got) == len(want) - len(per_layer) + \
        len(per_layer) * cfg.text_config.num_hidden_layers


def test_params_to_numpy_inverts_the_bridge(setup):
    cfg, _, tree = setup
    back = params_to_numpy(_torch_params(cfg, tree))
    _assert_tree_close(back, tree, 0, atol=0)


_METRICS = ("loss", "codec_loss", "aux_loss", "mean_top_k", "grad_norm", "skipped")


@pytest.mark.parametrize("pattern", [None, "moe/gate"])
def test_train_steps_match_optax(setup, pattern):
    """Three steps of `train_step` vs the JAX `train_step` with optax
    (lr 0 at step 0, then warmup done): parameters after each step and every
    metric; with trainable_pattern 'moe/gate' every other parameter keeps
    its initial value."""
    cfg, jp, tree = setup
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10, weight_decay=0.1,
              trainable_pattern=pattern)
    jopt = JS.make_optimizer(**kw)
    jstate = JS.init_train_state(jp, jopt)
    jstep = jax.jit(functools.partial(JS.train_step, cfg=cfg, optimizer=jopt, remat=False))
    topt = TS.make_optimizer(**kw)
    tstate = TS.init_train_state(_torch_params(cfg, tree), topt)
    for i in range(3):
        batch = _batch(cfg, seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        tstate, tm = TS.train_step(tstate, _tensors(batch), 0, cfg=cfg, optimizer=topt,
                                   remat=False)
        for k in _METRICS:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_RTOL,
                                       err_msg=f"step {i} {k}")
        _assert_params_close(params_to_numpy(tstate.params), jstate.params, 1e-3 * i)
        assert tstate.step == int(jstate.step) == i + 1
    if pattern is not None:
        frozen = {k: v for k, v in tree.items() if k != "layers"}
        for name in ("attn", "input_layernorm", "post_attention_layernorm"):
            frozen[name] = tree["layers"][name]
        now = params_to_numpy(tstate.params)
        now = {**{k: v for k, v in now.items() if k != "layers"},
               **{n: now["layers"][n] for n in ("attn", "input_layernorm",
                                                "post_attention_layernorm")}}
        _assert_tree_close(now, frozen, 0, atol=0)
        assert not np.array_equal(params_to_numpy(tstate.params)["layers"]["moe"]["gate"],
                                  tree["layers"]["moe"]["gate"])


def test_nonfinite_step_is_skipped(setup):
    """A batch whose embeddings hold a NaN gives a NaN loss: parameters,
    moments and the step count stay, `skipped` is 1; the next good batch
    steps as usual."""
    cfg, _, tree = setup
    opt = TS.make_optimizer(learning_rate=1e-3, warmup_steps=0, total_steps=10)
    state = TS.init_train_state(_torch_params(cfg, tree), opt)
    state, m = TS.train_step(state, _tensors(_batch(cfg, seed=4)), 0, cfg=cfg, optimizer=opt)
    assert m["skipped"].item() == 0 and state.step == 1
    before = params_to_numpy(state.params)
    mu_before = [t.clone() for t in state.opt_state.mu]
    bad = _tensors(_batch(cfg, seed=5))
    emb = torch.zeros(*bad["input_ids"].shape, cfg.text_config.hidden_size)
    emb[0, 3, 0] = float("nan")
    bad["inputs_embeds"] = emb
    state, m = TS.train_step(state, bad, 0, cfg=cfg, optimizer=opt)
    assert m["skipped"].item() == 1 and not np.isfinite(m["loss"].item())
    assert state.step == 1 and state.opt_state.count == 1
    _assert_tree_close(params_to_numpy(state.params), before, 0, atol=0)
    assert all(torch.equal(a, b) for a, b in zip(state.opt_state.mu, mu_before))
    state, m = TS.train_step(state, _tensors(_batch(cfg, seed=6)), 0, cfg=cfg, optimizer=opt)
    assert m["skipped"].item() == 0 and state.step == 2


def test_trainer_fit_matches_jax(setup):
    """`Trainer.fit` for 4 steps on the CPU vs the JAX `Trainer.fit` on the
    same batches (remat on, log every step): the same history length, losses
    and final parameters."""
    cfg, jp, tree = setup
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=8, log_every=1, remat=True)
    batches = [_batch(cfg, seed=20 + i) for i in range(4)]
    jtr = JTrainer(cfg, jax.tree.map(jnp.array, jp), JTrainerConfig(**kw))
    jhist = jtr.fit(batches)
    ttr = Trainer(cfg, _torch_params(cfg, tree), TrainerConfig(**kw), device="cpu")
    thist = ttr.fit(batches)
    assert len(thist) == len(jhist) == 4
    for t, j in zip(thist, jhist):
        assert t["step"] == j["step"]
        for k in ("loss", "codec_loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(t[k], j[k], rtol=LOSS_RTOL, err_msg=k)
    _assert_params_close(params_to_numpy(ttr.state.params), jtr.state.params,
                         sum(TS.make_lr_schedule(1e-3, 1, 8)(i) for i in range(4)))
    ev = ttr.evaluate(batches[:2])
    assert set(ev) == {"eval_loss", "eval_codec_loss", "eval_aux_loss", "eval_mean_top_k"}
    assert np.isfinite(ev["eval_loss"])


def test_trainer_fit_gmm_matches_jax(setup):
    """`Trainer.fit` with dispatch_mode='gmm' for 2 steps (remat on) vs the
    JAX `Trainer.fit` with the same config: losses, metrics, the final
    parameters and the gmm evaluation."""
    cfg, jp, tree = setup
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=8, log_every=1, remat=True,
              dispatch_mode="gmm")
    batches = [_batch(cfg, seed=30 + i) for i in range(2)]
    jtr = JTrainer(cfg, jax.tree.map(jnp.array, jp), JTrainerConfig(**kw))
    jhist = jtr.fit(batches)
    ttr = Trainer(cfg, _torch_params(cfg, tree), TrainerConfig(**kw), device="cpu")
    thist = ttr.fit(batches)
    assert len(thist) == len(jhist) == 2
    for t, j in zip(thist, jhist):
        for k in ("loss", "codec_loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(t[k], j[k], rtol=LOSS_RTOL, err_msg=k)
    _assert_params_close(params_to_numpy(ttr.state.params), jtr.state.params,
                         sum(TS.make_lr_schedule(1e-3, 1, 8)(i) for i in range(2)))
    jev, tev = jtr.evaluate(batches[:1]), ttr.evaluate(batches[:1])
    np.testing.assert_allclose(tev["eval_loss"], jev["eval_loss"], rtol=LOSS_RTOL)


def test_trainer_defaults_to_cuda_and_refuses_later_slices(setup):
    """Without a card the trainer refuses the default device; ring_axis
    without a mesh raises (the JAX trainer asserts a mesh), and so does an
    image batch for a model without a vision tower.  Checkpoints, gradient
    accumulation and save_pretrained run: tests/test_torch_train_core.py;
    vision batches: tests/test_torch_train_vision.py."""
    cfg, _, tree = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(cfg, _torch_params(cfg, tree), TrainerConfig())
    with pytest.raises(ValueError, match="mesh"):
        Trainer(cfg, _torch_params(cfg, tree), TrainerConfig(ring_axis="model"), device="cpu")
    tr = Trainer(cfg, _torch_params(cfg, tree), TrainerConfig(), device="cpu")
    with pytest.raises(ValueError, match="vision tower"):
        tr.fit([{**_batch(cfg, seed=0), "pixel_values": np.zeros((4, 8), np.float32),
                 "image_grid_thw": np.array([[1, 2, 2]])}])


def test_collator_matches_jax():
    insts = [
        {"input_ids": np.array([5, 6, 7, 9]), "labels": np.array([-100, 6, 7, 9])},
        {"input_ids": np.array([8, 9]), "labels": np.array([-100, 9])},
    ]
    for kw in ({"pad_token_id": 0, "aux_balance_weight": 10.0},
               {"pad_token_id": 0, "model_max_length": 3}):
        got = TD.Collator(**kw)(insts)
        want = JD.Collator(**kw)(insts)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype
