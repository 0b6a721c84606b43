"""Vision training of the PyTorch port vs the JAX package, f32 on the CPU:
`Trainer._prepare_vision_batch` in both modes (train_vision: the bucketed
host index arrays and the mRoPE positions; otherwise the tower's features
fused into inputs_embeds), `loss_fn` with the tower inside the
differentiated step (its leaves in the gradient), two `Trainer.fit` steps
with train_vision True and False against JAX's parameters, the freeze of
the tower by `trainable_pattern`, and `vision_tower_apply` under autograd on
padded indices.  Input jitter is off (the two frameworks draw different
noise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.models import vision as JV
from unimoe_audio_tpu.train import step as JS
from unimoe_audio_tpu.train.trainer import Trainer as JTrainer
from unimoe_audio_tpu.train.trainer import TrainerConfig as JTrainerConfig
from unimoe_audio_torch.core.bridge import params_from_jax, params_to_numpy, to_torch
from unimoe_audio_torch.models import vision as TV
from unimoe_audio_torch.train import step as TS
from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig
from tests.torch_threads import one_torch_thread  # noqa: F401

# tests/test_torch_train.py's tolerances.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-6
GRIDS = np.array([[1, 4, 4], [1, 4, 8]])          # 16 + 32 patches, 4 + 8 merged tokens


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config(with_vision=True, input_jitter_noise=0.0)
    jp = JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32, with_vision=True)
    return cfg, jp, jax.tree.map(np.asarray, jp)


def _image_batch(cfg, seed=0):
    """Two rows, each with a vision span of its image's merged tokens, text
    labels after it, one left pad, an aux_balance_weight."""
    vcfg = cfg.vision_config
    rng = np.random.default_rng(seed)
    patch_dim = vcfg.in_channels * vcfg.temporal_patch_size * vcfg.patch_size ** 2
    pv = rng.normal(size=(int(GRIDS.prod(1).sum()), patch_dim)).astype(np.float32)
    T = 20
    ids = rng.integers(5, 200, size=(2, T)).astype(np.int64)
    mask = np.ones((2, T), np.int64)
    for b, n in enumerate((4, 8)):
        ids[b, 3] = cfg.vision_start_token_id
        ids[b, 4:4 + n] = cfg.image_token_id
        ids[b, 4 + n] = cfg.vision_end_token_id
    ids[0, 0] = 0
    mask[0, 0] = 0
    labels = np.where(np.arange(T)[None] >= 13, ids, -100)
    return {"input_ids": ids, "labels": labels, "attention_mask": mask,
            "aux_balance_weight": np.where(labels != -100, 10.0, 1.0).astype(np.float32),
            "pixel_values": pv, "image_grid_thw": GRIDS}


def _assert_tree_close(got, want, rtol, atol_rel=None, atol=None):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        w = np.asarray(flat_w[path])
        tol = atol if atol is not None else atol_rel * max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def _trainers(cfg, jp, tree, **kw):
    kw = dict(learning_rate=1e-3, warmup_steps=1, total_steps=4, log_every=1, remat=False,
              vision_bucket=8, **kw)
    jtr = JTrainer(cfg, jax.tree.map(jnp.array, jp), JTrainerConfig(**kw))
    ttr = Trainer(cfg, params_from_jax(tree, cfg, "cpu"), TrainerConfig(**kw), device="cpu")
    return jtr, ttr


@pytest.mark.parametrize("train_vision", [True, False])
def test_prepare_vision_batch_equal(setup, train_vision):
    cfg, jp, tree = setup
    jtr, ttr = _trainers(cfg, jp, tree, train_vision=train_vision)
    batch = _image_batch(cfg)
    want = jtr._prepare_vision_batch(dict(batch))
    got = ttr._prepare_vision_batch(dict(batch))
    assert set(got) == set(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        if k == "inputs_embeds":        # JAX's tower jitted: its test's tolerance (tests/test_train.py)
            np.testing.assert_allclose(g, np.asarray(want[k]), rtol=2e-5, atol=2e-6)
        else:
            np.testing.assert_array_equal(g, np.asarray(want[k]), err_msg=k)
    if train_vision:
        assert got["vision_widx"].shape == (16,)          # 12 merged tokens padded to 16
    pos = got["position_ids"]
    assert not np.array_equal(pos[1], pos[2])                 # the spans' h and w rows


def test_loss_fn_vision_matches_jax(setup):
    """loss_fn with the tower in the step: the loss and every gradient,
    the tower's included, against JAX's (jitted: all f32); remat on."""
    cfg, jp, tree = setup
    jtr, ttr = _trainers(cfg, jp, tree)
    prepared = jtr._prepare_vision_batch(_image_batch(cfg))
    (jloss, _), jgrads = jax.jit(lambda p, b: jax.value_and_grad(JS.loss_fn, has_aux=True)(
        p, cfg, b, jax.random.PRNGKey(0), jnp.float32(0.025), remat=False))(
        jp, {k: jnp.asarray(v) for k, v in prepared.items()})
    params = ttr.state.params
    batch = ttr._place_batch(ttr._prepare_vision_batch(_image_batch(cfg)))
    loss, _ = TS.loss_fn(params, cfg, batch, 0, 0.025, remat=True)
    leaves = [t for _, t in TS.named_leaves(params)]
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        if isinstance(t, list):
            return [rebuild(v) for v in t]
        g = next(grads)
        return torch.zeros_like(t) if g is None else g
    got = params_to_numpy(rebuild(params))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _assert_tree_close(got, jax.tree.map(np.asarray, jgrads), GRAD_RTOL, GRAD_ATOL_REL)
    assert np.abs(got["vision"]["patch_embed"]).max() > 0


@pytest.mark.parametrize("train_vision", [True, False])
def test_trainer_fit_vision_matches_jax(setup, train_vision):
    """Two Trainer.fit steps on the image batch (the first at lr 0): the
    losses and final parameters against JAX's.  With train_vision the tower
    moves; without it the tower stays bit-equal while the decoder moves."""
    cfg, jp, tree = setup
    jtr, ttr = _trainers(cfg, jp, tree, train_vision=train_vision)
    batches = [_image_batch(cfg, seed=s) for s in (1, 2)]
    jhist, thist = jtr.fit(batches), ttr.fit(batches)
    assert len(thist) == len(jhist) == 2
    for t, j in zip(thist, jhist):
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(t[k], j[k], rtol=LOSS_RTOL, err_msg=k)
    got = params_to_numpy(ttr.state.params)
    want = jax.tree.map(np.asarray, jtr.state.params)
    kb_got = got["layers"]["attn"]["k_proj"].pop("b")       # see test_torch_train.py
    kb_want = want["layers"]["attn"]["k_proj"].pop("b")
    _assert_tree_close(got, want, PARAM_RTOL, atol=PARAM_ATOL)
    np.testing.assert_allclose(kb_got, kb_want, rtol=0, atol=2 * 1e-3 + PARAM_ATOL)
    pe_moved = np.abs(got["vision"]["patch_embed"] - tree["vision"]["patch_embed"]).max()
    assert (pe_moved > 0) == train_vision
    assert np.abs(got["layers"]["attn"]["q_proj"]["w"]
                  - tree["layers"]["attn"]["q_proj"]["w"]).max() > 0


def test_trainer_vision_freeze_by_pattern(setup):
    """train_vision with trainable_pattern r"^(?!vision)": the tower's
    gradient is computed and its update zeroed, so it stays bit-equal while
    embed_tokens moves (the JAX package's tests/test_train.py:264-283)."""
    cfg, _, tree = setup
    ttr = Trainer(cfg, params_from_jax(tree, cfg, "cpu"),
                  TrainerConfig(learning_rate=1e-3, warmup_steps=1, total_steps=4, log_every=1,
                                remat=False, vision_bucket=8, trainable_pattern=r"^(?!vision)"),
                  device="cpu")
    hist = ttr.fit([_image_batch(cfg, seed=s) for s in (1, 2)])
    assert all(np.isfinite(h["loss"]) for h in hist)
    got = params_to_numpy(ttr.state.params)
    for path, leaf in jax.tree_util.tree_flatten_with_path(got["vision"])[0]:
        want = tree["vision"]
        for p in path:
            want = want[p.key if hasattr(p, "key") else p.idx]
        np.testing.assert_array_equal(leaf, want)
    assert np.abs(got["embed_tokens"] - tree["embed_tokens"]).max() > 0


def test_vision_tower_apply_padded_under_autograd(setup):
    """vision_tower_apply on indices padded 12 → 16 merged tokens equals
    vision_forward on the unpadded grids (the JAX test's tolerance), and
    under autograd the padding patches get zero gradient while the real
    ones get vision_forward's gradient."""
    cfg, jp, tree = setup
    vcfg = cfg.vision_config
    vp = to_torch(tree["vision"], "cpu", torch.float32)
    pv = torch.tensor(_image_batch(cfg)["pixel_values"], requires_grad=True)
    m2 = vcfg.spatial_merge_size ** 2
    idx = TV.vision_indices(GRIDS, vcfg, pad_merged_to=16)
    pad = torch.zeros((16 - 12) * m2, pv.shape[1], requires_grad=True)
    t = {k: torch.as_tensor(idx[k]) for k in ("pos", "win_ids", "sample_ids", "widx", "reverse")}
    got = TV.vision_tower_apply(vp, torch.cat([pv, pad]), t["pos"], t["win_ids"],
                                t["sample_ids"], t["widx"], t["reverse"], vcfg)
    want = TV.vision_forward(vp, pv, GRIDS, vcfg)
    jwant = np.asarray(JV.vision_forward(tree["vision"], jnp.asarray(pv.detach().numpy()), GRIDS,
                                         vcfg))
    np.testing.assert_allclose(got[:12].detach().numpy(), want.detach().numpy(), rtol=2e-5,
                               atol=2e-6)
    np.testing.assert_allclose(want.detach().numpy(), jwant, rtol=2e-5, atol=2e-6)
    w = torch.randn(want.shape, generator=torch.Generator().manual_seed(0))
    g_pad, g_pv = torch.autograd.grad((got[:12] * w).sum(), [pad, pv])
    (g_ref,) = torch.autograd.grad((want * w).sum(), [pv])
    assert torch.equal(g_pad, torch.zeros_like(g_pad))
    torch.testing.assert_close(g_pv, g_ref, rtol=1e-4, atol=1e-6)
    assert g_pv.abs().max() > 0
