"""The layer-streamed trainer of the PyTorch port (`train/stream.py`) vs the
JAX package's, f32 on the CPU (input jitter off wherever the two are
compared: they draw different noise): 3 steps (codec labels, then codec and
text labels with lm_head, then codec labels) — loss, aux, grad norm and the
parameters; gradient accumulation over two micro-batches; `evaluate`; a
checkpoint written by the JAX StreamTrainer resumed in the port.  In the
port alone: the split/gather round trip and random init, StreamTrainer =
OffloadTrainer = Trainer with jitter on (`tests/test_stream.py`'s
tolerances), identical micro-batches against one step, the skip of a
non-finite step and of a non-finite micro-batch, mixed label kinds and no
labels refused, save → restore → resume bit-equal (f32 and int8 moments),
the moment-format conversion on restore and the optimizer-less restore."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_train import LOSS_RTOL, _assert_params_close, _batch
from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.train.stream import StreamTrainer as JStream
from unimoe_audio_torch.core.bridge import params_from_jax, params_to_numpy
from unimoe_audio_torch.models.model import init_model_params
from unimoe_audio_torch.train.offload import OffloadAdamW, OffloadTrainer
from unimoe_audio_torch.train.step import make_lr_schedule, named_leaves, train_step
from unimoe_audio_torch.train.stream import StreamTrainer
from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig

LR, WD, WARMUP, TOTAL = 1e-3, 0.1, 2, 10
# StreamTrainer against OffloadTrainer (`tests/test_stream.py:45-78`).
STREAM_LOSS_RTOL, STREAM_AUX_RTOL, STREAM_GNORM_RTOL, STREAM_PARAM_ATOL = 2e-5, 2e-4, 1e-3, 5e-5
KW = dict(weight_decay=WD, grad_clip=1.0, device="cpu")


def _jsched():
    return optax.warmup_cosine_decay_schedule(0.0, LR, WARMUP, TOTAL)


def _tsched():
    return make_lr_schedule(LR, WARMUP, TOTAL)


def _cfg(**kw):
    return tiny_test_config(input_jitter_noise=0.0, **kw)


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _batches(cfg):
    return [_batch(cfg, 1), _batch(cfg, 2, text_labels=True), _batch(cfg, 3)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX StreamTrainer (f32, lm_head trained) for 3 steps, its
    checkpoint written after step 2, then `evaluate` on the first two
    batches; and a second one for 2 accumulated steps of two micro-batches."""
    cfg = _cfg()
    jp = JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    ck = str(tmp_path_factory.mktemp("jck"))
    st = JStream(cfg, jax.tree.map(jnp.array, tree), learning_rate=_jsched(), weight_decay=WD,
                 grad_clip=1.0, train_lm_head=True)
    batches = _batches(cfg)
    metrics = []
    for i, b in enumerate(batches):
        metrics.append(st.train_step(_jbatch(b), jax.random.PRNGKey(7)))
        if i == 1:
            st.save(ck)
    ev = st.evaluate([_jbatch(b) for b in batches[:2]])
    acc = JStream(cfg, jax.tree.map(jnp.array, tree), learning_rate=_jsched(), weight_decay=WD,
                  grad_clip=1.0)
    acc_metrics = [acc.train_step([_jbatch(batches[0]), _jbatch(batches[2])],
                                  jax.random.PRNGKey(7)) for _ in range(2)]
    return dict(cfg=cfg, tree=tree, metrics=metrics, params=st.full_params(), ckpt=ck, eval=ev,
                acc_metrics=acc_metrics, acc_params=acc.full_params())


def _assert_metrics(got, want, keys=("loss", "codec_loss", "aux_loss", "grad_norm")):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    assert got["skipped"] == want["skipped"] == 0.0


def _lr_sum(steps):
    return sum(_tsched()(c) for c in range(steps))


def test_three_steps_match_jax(jax_run):
    cfg, tree = jax_run["cfg"], jax_run["tree"]
    st = StreamTrainer(cfg, params_from_jax(tree, cfg, "cpu"), learning_rate=_tsched(),
                       train_lm_head=True, **KW)
    for b, want in zip(_batches(cfg), jax_run["metrics"]):
        _assert_metrics(st.train_step(b, 7), want)
    assert st.step == 3
    _assert_params_close(params_to_numpy(st.full_params()), jax_run["params"], _lr_sum(3))
    st.close()


def test_grad_accumulation_matches_jax(jax_run):
    """2 accumulated steps of two micro-batches: every metric at LOSS_RTOL."""
    cfg, tree = jax_run["cfg"], jax_run["tree"]
    st = StreamTrainer(cfg, params_from_jax(tree, cfg, "cpu"), learning_rate=_tsched(), **KW)
    b = _batches(cfg)
    for want in jax_run["acc_metrics"]:
        got = st.train_step([b[0], b[2]], 7)
        _assert_metrics(got, want)
        assert got["micro_batches"] == want["micro_batches"] == 2.0
    assert st.step == 2
    # The sums of two micro-batches' gradients round in another order than
    # JAX's, and Adam turns that rounding on near-zero gradient elements into
    # steps of up to the lr: the parameters are held at the JAX test's
    # stream-against-offload atol (5e-5, `tests/test_stream.py:45-78`).
    got, want = params_to_numpy(st.full_params()), jax_run["acc_params"]
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=STREAM_PARAM_ATOL),
                 got, want)


def test_evaluate_matches_jax(jax_run):
    """The JAX trainer's eval after its 3 steps, against the port's trainer
    restored from the JAX checkpoint (step 2) and stepped once more."""
    cfg = jax_run["cfg"]
    st = StreamTrainer(cfg, restore_dir=jax_run["ckpt"], learning_rate=_tsched(),
                       train_lm_head=True, param_dtype=torch.float32, **KW)
    assert st.step == 2 and st.outer_state.count == 2
    _assert_metrics(st.train_step(_batches(cfg)[2], 7), jax_run["metrics"][2])
    _assert_params_close(params_to_numpy(st.full_params()), jax_run["params"], _lr_sum(3))
    got = st.evaluate(_batches(cfg)[:2])
    for k, v in jax_run["eval"].items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)
    before = [t.clone() for lp in st.layers_host for t in lp]
    assert st.evaluate(_batches(cfg)[:2]) == got
    assert all(torch.equal(a, b) for a, b in zip(before, [t for lp in st.layers_host
                                                         for t in lp]))


def test_split_gather_round_trip_and_random_init():
    cfg = tiny_test_config(num_hidden_layers=3)
    params = init_model_params(cfg, seed=4, dtype=torch.float32, device="cpu")
    back = StreamTrainer(cfg, params, train_lm_head=True, **KW).full_params()
    for (na, a), (nb, b) in zip(named_leaves(params), named_leaves(back)):
        assert na == nb and torch.equal(a, b), na
    assert list(back) == list(params)
    rand = StreamTrainer(cfg, seed=4, param_dtype=torch.float32, **KW).full_params()
    for (na, a), (_, b) in zip(named_leaves(params), named_leaves(rand)):
        assert torch.equal(a, b), na


def test_stream_equals_offload_equals_trainer_with_jitter():
    """Jitter on (the port draws it from the same seeds in all three): 3
    steps of each, metrics and parameters at the JAX test's tolerances."""
    cfg = tiny_test_config(num_hidden_layers=3)
    assert cfg.text_config.input_jitter_noise > 0

    def fresh():
        return init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu")

    st = StreamTrainer(cfg, fresh(), learning_rate=_tsched(), train_lm_head=True, **KW)
    ot = OffloadTrainer(cfg, fresh(), OffloadAdamW(learning_rate=_tsched(), weight_decay=WD,
                                                   grad_clip=1.0), remat=False, device="cpu")
    tr = Trainer(cfg, fresh(), TrainerConfig(learning_rate=LR, weight_decay=WD,
                                             warmup_steps=WARMUP, total_steps=TOTAL),
                 device="cpu")
    for b in _batches(cfg):
        ms, mo = st.train_step(b, 7), ot.train_step(b, 7)
        tr.state, mt = train_step(tr.state, tr._place_batch(b), 7, cfg=cfg,
                                  optimizer=tr.optimizer, remat=False)
        for m in (mo, {k: float(v) for k, v in mt.items()}):
            np.testing.assert_allclose(ms["loss"], m["loss"], rtol=STREAM_LOSS_RTOL)
            np.testing.assert_allclose(ms["aux_loss"], m["aux_loss"], rtol=STREAM_AUX_RTOL)
            np.testing.assert_allclose(ms["grad_norm"], m["grad_norm"], rtol=STREAM_GNORM_RTOL)
    for (n, a), (_, b), (_, c) in zip(named_leaves(st.full_params()),
                                      named_leaves(ot.state.params),
                                      named_leaves(tr.state.params)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=STREAM_PARAM_ATOL,
                                   err_msg=n)
        np.testing.assert_allclose(c.detach().numpy(), b.detach().numpy(),
                                   atol=STREAM_PARAM_ATOL, err_msg=n)


def _nojitter(**kw):
    return tiny_test_config(router_jitter_noise=0.0, input_jitter_noise=0.0, l_aux_weight=0.01,
                            min_l_aux_weight=0.01, **kw)


def test_identical_micro_batches_equal_one_step():
    """train_step([b, b]) applies the clipped mean of the sums: (2g)·(s/2)
    == g·s in f32, so the parameters match one step of b (the JAX test's
    atol 1e-7, `tests/test_stream.py`)."""
    cfg = _nojitter()
    params = init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    a = StreamTrainer(cfg, params, learning_rate=LR, **KW)
    b2 = StreamTrainer(cfg, params, learning_rate=LR, **KW)
    b = _batch(cfg, 1)
    m1, m2 = a.train_step(b, 7), b2.train_step([b, b], 7)
    assert m2["micro_batches"] == 2.0 and b2.step == 1
    np.testing.assert_allclose(m1["loss"], m2["loss"], rtol=1e-6)
    np.testing.assert_allclose(m1["grad_norm"], m2["grad_norm"], rtol=1e-5)
    for (n, x), (_, y) in zip(named_leaves(a.full_params()), named_leaves(b2.full_params())):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-7, err_msg=n)
    m = b2.train_step([b], 7)
    assert "micro_batches" not in m and b2.step == 2


@pytest.mark.parametrize("micro", [False, True])
def test_non_finite_step_skips(micro):
    cfg = _nojitter()
    st = StreamTrainer(cfg, init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu"),
                       learning_rate=LR, **KW)
    st.layers_host[1][st._paths.index(("attn", "q_proj", "w"))][0, 0] = float("nan")
    before = st.full_params()
    mom = [t.clone() for lp in st.mu for t in lp]
    b = _batch(cfg, 1)
    m = st.train_step([b, _batch(cfg, 2)] if micro else b, 0)
    assert m["skipped"] == 1.0 and st.step == 0
    for (n, x), (_, y) in zip(named_leaves(before), named_leaves(st.full_params())):
        assert torch.equal(x.nan_to_num(), y.nan_to_num()), n
    assert all(torch.equal(a, b) for a, b in zip(mom, [t for lp in st.mu for t in lp]))


def test_label_kinds():
    """Mixed label kinds across micro-batches raise; text labels need
    train_lm_head; a batch with neither label kind raises; a text-only batch
    trains with a zero codec loss."""
    cfg = _nojitter()
    params = init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    st = StreamTrainer(cfg, params, learning_rate=LR, train_lm_head=True, **KW)
    with pytest.raises(ValueError, match="label kinds"):
        st.train_step([_batch(cfg, 1), _batch(cfg, 2, text_labels=True)], 0)
    with pytest.raises(ValueError, match="labels"):
        st.train_step({"input_ids": np.zeros((1, 4), np.int32)}, 0)
    text = _batch(cfg, 2, text_labels=True)
    text.pop("codec_labels")
    m = st.train_step(text, 0)
    assert m["skipped"] == 0.0 and m["codec_loss"] == 0.0 and np.isfinite(m["loss"])
    frozen = StreamTrainer(cfg, params, learning_rate=LR, **KW)
    with pytest.raises(ValueError, match="train_lm_head"):
        frozen.train_step(_batch(cfg, 2, text_labels=True), 0)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_save_restore_resume_bit_equal(tmp_path, moment_dtype):
    """2 steps + save + a new trainer from the checkpoint + 2 steps equals
    4 straight steps bit for bit (the int8 codes' stochastic rounding is
    keyed on the step count, not on the process)."""
    cfg = tiny_test_config()
    kw = dict(learning_rate=_tsched(), moment_dtype=moment_dtype, **KW)
    params = init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    straight = StreamTrainer(cfg, params, **kw)
    first = StreamTrainer(cfg, params, **kw)
    batches = [_batch(cfg, s) for s in range(4)]
    for b in batches:
        straight.train_step(b, 7)
    for b in batches[:2]:
        first.train_step(b, 7)
    first.save(str(tmp_path))
    second = StreamTrainer(cfg, restore_dir=str(tmp_path), param_dtype=torch.float32, **kw)
    for b in batches[2:]:
        second.train_step(b, 7)
    assert second.step == 4
    for (n, x), (_, y) in zip(named_leaves(straight.full_params()),
                              named_leaves(second.full_params())):
        assert torch.equal(x, y), n
    for x, y in zip([t for lp in straight.mu + straight.nu for t in lp],
                    [t for lp in second.mu + second.nu for t in lp]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="train_lm_head"):
        StreamTrainer(cfg, restore_dir=str(tmp_path), train_lm_head=True, **KW)


def test_restore_converts_moment_formats(tmp_path):
    """An f32-moment checkpoint restores into an int8 trainer (codes equal to
    round-to-nearest of the saved moments) and back; the next step's loss is
    the same, training goes on."""
    cfg = tiny_test_config()
    st = StreamTrainer(cfg, init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu"),
                       learning_rate=_tsched(), **KW)
    for s in range(2):
        st.train_step(_batch(cfg, s), 7)
    st.save(str(tmp_path / "f32"))
    st8 = StreamTrainer(cfg, restore_dir=str(tmp_path / "f32"), learning_rate=_tsched(),
                        param_dtype=torch.float32, moment_dtype="int8", **KW)
    from unimoe_audio_torch.train.qmoment import padded_len, quantize_blockwise
    n = st8._sizes[0]
    q, s = quantize_blockwise(torch.nn.functional.pad(st.mu[0][0], (0, padded_len(n) - n)),
                              signed=True)
    assert torch.equal(st8.mu[0][0], q) and torch.equal(st8.mu[0][1], s)
    nxt = _batch(cfg, 5)
    m32, m8 = st.train_step(nxt, 7), st8.train_step(nxt, 7)
    np.testing.assert_allclose(m8["loss"], m32["loss"], rtol=1e-6)
    st8.save(str(tmp_path / "int8"))
    back = StreamTrainer(cfg, restore_dir=str(tmp_path / "int8"), learning_rate=_tsched(),
                         param_dtype=torch.float32, **KW)
    assert back.step == 3 and np.isfinite(back.train_step(_batch(cfg, 6), 7)["loss"])


def test_optimizerless_restore_aligns_outer_schedule(tmp_path):
    cfg = tiny_test_config()
    st = StreamTrainer(cfg, init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu"),
                       learning_rate=_tsched(), **KW)
    for s in range(3):
        st.train_step(_batch(cfg, s), 7)
    st.save(str(tmp_path), include_optimizer=False)
    st2 = StreamTrainer(cfg, restore_dir=str(tmp_path), learning_rate=_tsched(),
                        param_dtype=torch.float32, **KW)
    assert st2.step == 3 and st2.outer_state.count == 3
    assert all(int(t.abs().max()) == 0 for lp in st2.mu for t in lp)


def test_refuses_sliding_layers():
    tc = dataclasses.replace(tiny_test_config().text_config, use_sliding_window=True,
                             sliding_window=4, layer_types=("sliding_attention",) * 2)
    cfg = dataclasses.replace(tiny_test_config(), text_config=tc)
    with pytest.raises(ValueError, match="sliding"):
        StreamTrainer(cfg, seed=0, **KW)
