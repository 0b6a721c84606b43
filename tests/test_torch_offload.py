"""The offload trainer of the PyTorch port (`train/offload.py`) vs the JAX
package's, f32 on the CPU: `_chunk_bounds` on a table of shapes;
`OffloadAdamW` fed the same gradients as the JAX `OffloadAdamW` for 3 steps
(weight decay 0.1, clip 1.0, warm-up-cosine schedule, leaves chunked) at
rtol 1e-6; the skip of a non-finite step; `OffloadTrainer` against the JAX
`OffloadTrainer` for 2 steps (input jitter off: the two frameworks draw
different noise) at `test_torch_train.py`'s tolerances; int8 moments, whose
first step equals the f32 step bit for bit and whose next steps track it;
the host arena and the copies it takes on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_train import LOSS_RTOL, _assert_params_close
from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.train import offload as JO
from unimoe_audio_torch.core.bridge import params_from_jax, params_to_numpy
from unimoe_audio_torch.train import offload as TO
from unimoe_audio_torch.train.step import make_lr_schedule, named_leaves
from tests.torch_threads import one_torch_thread  # noqa: F401

OPT_RTOL = 1e-6
LR, WD, WARMUP, TOTAL = 1e-3, 0.1, 2, 10


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config(input_jitter_noise=0.0)
    jp = JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return cfg, jp, jax.tree.map(np.asarray, jp)


def _batch(cfg, seed, B=2, T=8):
    rng = np.random.default_rng(seed)
    codec = rng.integers(0, cfg.codec_eos_value, size=(B, T, cfg.codec_channels)).astype(np.int32)
    return {"input_ids": np.full((B, T), cfg.codec_placeholder_value, np.int32),
            "codec_input_ids": codec, "attention_mask": np.ones((B, T), np.int32),
            "codec_labels": codec}


@pytest.mark.parametrize("shape,chunk_bytes", [
    ((8, 4), 10 ** 9), ((8, 1024), 8 * 1024), ((), 1), ((7,), 4), ((5, 3, 2), 16),
    ((151, 64), 4096), ((3, 2048, 2752), 512 << 20), ((151676, 2048), 512 << 20)])
def test_chunk_bounds_match_jax(shape, chunk_bytes):
    assert TO._chunk_bounds(shape, chunk_bytes) == JO._chunk_bounds(shape, chunk_bytes)


def _sched():
    return (optax.warmup_cosine_decay_schedule(0.0, LR, WARMUP, TOTAL),
            make_lr_schedule(LR, WARMUP, TOTAL))


def test_offload_adamw_matches_jax(setup):
    """The same gradients (3 x N(0, 1), so the clip acts) into both
    optimizers, 3 steps: parameters at rtol 1e-6; several leaves chunked."""
    cfg, _, tree = setup
    jsched, tsched = _sched()
    jopt = JO.OffloadAdamW(learning_rate=jsched, weight_decay=WD, grad_clip=1.0,
                           chunk_bytes=1 << 14)
    jstate = jopt.init_state(jax.tree.map(jnp.array, tree))     # apply donates the leaves
    topt = TO.OffloadAdamW(learning_rate=tsched, weight_decay=WD, grad_clip=1.0,
                           chunk_bytes=1 << 14)
    tstate = topt.init_state(params_from_jax(tree, cfg, "cpu"))
    assert sum(len(chunks) > 1 for chunks in tstate.mu) >= 4
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = jax.tree.map(lambda p: (3.0 * rng.standard_normal(p.shape)).astype(np.float32), tree)
        gnorm = float(np.sqrt(sum(np.sum(np.square(x, dtype=np.float64))
                                  for x in jax.tree.leaves(g))))
        jstate = jopt.apply(jstate, jax.tree.map(jnp.asarray, g), jnp.float32(gnorm))
        grads = [t for _, t in named_leaves(params_from_jax(g, cfg, "cpu"))]
        topt.apply(tstate, grads, gnorm)
        assert all(x is None for x in grads)           # consumed
    assert tstate.count == tstate.step == 3
    got = params_to_numpy(tstate.params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=OPT_RTOL, atol=1e-7),
                 got, jax.tree.map(np.asarray, jstate.params))
    tstate.close()


def _trainer(cfg, tree, moment_dtype="float32", **kw):
    opt = TO.OffloadAdamW(learning_rate=_sched()[1], weight_decay=WD, grad_clip=1.0,
                          chunk_bytes=1 << 14, moment_dtype=moment_dtype)
    return TO.OffloadTrainer(cfg, params_from_jax(tree, cfg, "cpu"), opt, remat=False,
                             device="cpu", **kw)


def test_offload_trainer_matches_jax(setup):
    """2 steps of each trainer on the same batches: every metric at
    LOSS_RTOL, the parameters at `test_torch_train.py`'s tolerances."""
    cfg, _, tree = setup
    jopt = JO.OffloadAdamW(learning_rate=_sched()[0], weight_decay=WD, grad_clip=1.0,
                           chunk_bytes=1 << 14)
    jtr = JO.OffloadTrainer(cfg, jax.tree.map(jnp.array, tree), jopt, remat=False)
    ttr = _trainer(cfg, tree)
    lr_sum = 0.0
    for i in range(2):
        b = _batch(cfg, seed=i)
        jm = jtr.train_step({k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))
        tm = ttr.train_step(b, 0)
        lr_sum += _sched()[1](i)
        for k in ("loss", "codec_loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(tm[k], jm[k], rtol=LOSS_RTOL, err_msg=k)
        assert tm["skipped"] == jm["skipped"] == 0.0
    _assert_params_close(params_to_numpy(ttr.state.params), jtr.state.params, lr_sum)
    ttr.close()


def test_offload_trainer_skips_non_finite_step(setup):
    cfg, _, tree = setup
    tr = _trainer(cfg, tree)
    with torch.no_grad():
        tr.state.params["layers"][0]["attn"]["q_proj"]["w"][0, 0] = float("nan")
    before = [t.detach().clone() for _, t in named_leaves(tr.state.params)]
    mom = [t.clone() for chunks in tr.state.mu for parts in chunks for t in parts]
    m = tr.train_step(_batch(cfg, seed=0), 0)
    assert m["skipped"] == 1.0 and tr.state.step == tr.state.count == 0
    for a, (_, b) in zip(before, named_leaves(tr.state.params)):
        assert torch.equal(a.nan_to_num(), b.detach().nan_to_num())
    assert all(torch.equal(a, b) for a, b in
               zip(mom, [t for chunks in tr.state.mu for parts in chunks for t in parts]))


def test_int8_moments_first_step_exact_then_tracks(setup):
    """Zero moments dequantize to exactly 0 and the update runs in f32 before
    the moments are requantized, so step 1 equals the f32 step bit for bit;
    step 2 reads quantized moments and moves each leaf within 25 % of the
    f32 step's largest move (the JAX test's bound, `tests/test_qmoment.py`)."""
    cfg, _, tree = setup
    cfg = dataclasses.replace(cfg, text_config=dataclasses.replace(
        cfg.text_config, router_jitter_noise=0.0))
    a, b = _trainer(cfg, tree), _trainer(cfg, tree, moment_dtype="int8")
    batch = _batch(cfg, seed=0)
    ma, mb = a.train_step(batch, 7), b.train_step(batch, 7)
    assert ma["loss"] == mb["loss"] and ma["grad_norm"] == mb["grad_norm"]
    for (n, x), (_, y) in zip(named_leaves(a.state.params), named_leaves(b.state.params)):
        assert torch.equal(x, y), n
    p1 = [t.detach().clone() for _, t in named_leaves(a.state.params)]
    for _ in range(2):
        ma, mb = a.train_step(batch, 7), b.train_step(batch, 7)
    np.testing.assert_allclose(mb["loss"], ma["loss"], rtol=1e-3)
    for (n, x), (_, y), p0 in zip(named_leaves(a.state.params), named_leaves(b.state.params),
                                  p1):
        da, db = (x - p0).detach(), (y - p0).detach()
        if da.abs().max() > 0:
            assert float((db - da).abs().max() / da.abs().max()) < 0.25, n
    a.close()
    b.close()


def test_host_arena_and_copies_on_cpu():
    """Buffers at their specs' shapes and dtypes, zeroed, 256-byte aligned;
    on the CPU `fetch` gives real copies and `store` writes back."""
    specs = [((3, 5), torch.bfloat16), ((7,), torch.float32), ((2049,), torch.uint8)]
    arena = TO.HostArena(specs, "cpu")
    assert [(tuple(t.shape), t.dtype) for t in arena.tensors] == specs
    assert all(t.data_ptr() % TO.HostArena.ALIGN == 0 for t in arena.tensors)
    assert all(int(t.float().abs().sum()) == 0 for t in arena.tensors)
    st = TO.Streamer("cpu")
    devs = st.ready(st.fetch(arena.tensors))
    devs[1] += 1
    assert int(arena.tensors[1].sum()) == 0
    st.wait(st.store(devs, arena.tensors))
    assert int(arena.tensors[1].sum()) == 7
    arena.close()


def test_trainers_need_a_card_without_cpu(setup):
    """Without device='cpu' both trainers ask for the card."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg, _, tree = setup
    from unimoe_audio_torch.train.stream import StreamTrainer
    with pytest.raises(RuntimeError, match="cpu"):
        StreamTrainer(cfg, seed=0)
    with pytest.raises(RuntimeError, match="cpu"):
        TO.OffloadTrainer(cfg, params_from_jax(tree, cfg, "cpu"), TO.OffloadAdamW(learning_rate=LR))
