"""The port's sequence and pipeline parallelism on the CPU, held to the JAX
package's `tests/test_ring_attention.py`, `tests/test_seq_sharding.py` and
`tests/test_pipeline.py`, and the mesh trainer's replicated batch and the
DCMoE block's `token_drop` on a split batch.

Four gloo ranks (`tests/torch_seq_worker.py`) start once for the file and
run every case; the JAX side runs in this process on the harness's
virtual CPU devices while they work (weights cross over through
`core/bridge.py`):

  * `ring_attention` over four ranks against JAX's `ring_attention` under
    `shard_map` over four devices and against `_reference_attention`, f32,
    rtol 2e-5, atol 2e-6; the gradients of q, k and v against the oracle's,
    rtol 3e-5, atol 3e-6;
  * `text_model_forward(ring=...)` against JAX's with its ring, rtol and
    atol 3e-5; `loss_fn(ring=...)` against JAX's with and without ring
    (loss rtol 1e-5, gradients atol 3e-5, rtol 2e-4), equal on every rank;
  * `Trainer(ring_axis="model")` on (1, 1, 4) and (2, 1, 2) against the
    mesh-less trainer: losses rtol 1e-4, gradient norms rtol 1e-3, the
    parameters after a step as `tests/test_torch_parallel.py`;
  * `text_model_forward(seq_axis="model")` on (2, 1, 2) with tensor
    parallelism against JAX's `hidden_sharding`, rtol 3e-4, atol 3e-5; its
    `loss_fn` gradients against the unsharded port's, atol 3e-5, rtol 2e-4;
  * `pipeline_forward` at (stages, n_micro) (2, 2), (4, 4) and (2, 4)
    against JAX's `pipeline_forward` and `text_model_forward`, its layer
    and input gradients against the plain forward's, rtol 3e-4, atol 3e-5;
  * a 3-row batch on (2, 2, 1) against the mesh-less trainer and JAX's
    `Trainer` on the same mesh; `token_drop` ("probs", "position") on a
    batch split over four ranks against JAX's `dcmoe_block` and the port's
    unsplit block, atol 1e-5;
  * the refusals.
"""

import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tests import torch_seq_cases as C
from tests.test_torch_parallel import _assert_params_close
from unimoe_audio_torch.core.bridge import params_to_numpy
from tests.torch_threads import one_torch_thread  # noqa: F401

try:
    from jax.experimental.shard_map import shard_map
except ImportError:
    from jax.shard_map import shard_map

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_seq_worker.py")
JAX_REFS = os.path.join(os.path.dirname(WORKER), "torch_seq_jax.py")
REPO = os.path.dirname(os.path.dirname(WORKER))


def _addr() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


class Ranks:
    def __init__(self, base):
        self.base = base
        self.procs = []
        self._res = None

    def start(self):
        """The four ranks, and the JAX references that take longest to
        compile in a process beside them."""
        addr = _addr()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=REPO, PYTHONHASHSEED="0")
        for r, argv in [(r, [WORKER, str(r), addr]) for r in range(C.WORLD)] + [
                ("_jax", [JAX_REFS])]:
            log = open(os.path.join(self.base, f"log{r}.txt"), "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, *argv, self.base], stdout=log, stderr=subprocess.STDOUT,
                env=env, cwd=REPO))

    def _wait(self):
        for p in self.procs:
            p.wait(timeout=600)
        logs = [open(os.path.join(self.base, f"log{r}.txt")).read()[-3000:]
                for r in [*range(C.WORLD), "_jax"]]
        assert all(p.returncode == 0 for p in self.procs), "\n".join(logs)

    def results(self, rank: int = 0):
        if self._res is None:
            self._wait()
            self._res = [pickle.load(open(os.path.join(self.base, f"rank{r}.pkl"), "rb"))
                         for r in range(C.WORLD)]
            with open(os.path.join(self.base, "jax.pkl"), "rb") as f:
                self.jax.update(pickle.load(f))
        return self._res[rank]

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = Ranks(str(tmp_path_factory.mktemp("seq")))
    r.start()
    try:
        # The references, computed while the ranks work.
        r.jax = _jax_references()
        r.single = _single_references()
        yield r
    finally:
        r.stop()


# -- references ------------------------------------------------------------------

def _jparams(cfg):
    return jax.tree.map(jnp.asarray, params_to_numpy(C.port_params(cfg)))


def _ring_fn(n):
    from unimoe_audio_tpu.ops.ring_attention import ring_attention

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("seq",))
    return shard_map(
        lambda q, k, v, val: ring_attention(q, k, v, val, axis_name="seq", causal=True),
        mesh=mesh, in_specs=(P(None, None, "seq", None),) * 3 + (P(None, "seq"),),
        out_specs=P(None, None, "seq", None), check_rep=False)


def _jax_references():
    from unimoe_audio_tpu.config import tiny_test_config as jax_tiny
    from unimoe_audio_tpu.models.model import text_model_forward as j_forward
    from unimoe_audio_tpu.moe.block import dcmoe_block as j_block
    from unimoe_audio_tpu.ops.flash_attention import _reference_attention
    from unimoe_audio_tpu.parallel.pipeline import pipeline_forward as j_pipeline

    out = {}
    ring = _ring_fn(C.WORLD)
    for shape in C.RING_SHAPES:
        q, k, v, valid, co = (jnp.asarray(a) for a in C.ring_inputs(*shape))

        def oracle(a, b, c, valid=valid, co=co):
            o = _reference_attention(a, b, c, valid, True)
            return jnp.sum(o * co), o

        (_, want), grads = jax.jit(jax.value_and_grad(oracle, argnums=(0, 1, 2), has_aux=True))(
            q, k, v)
        out[("ring_op", shape)] = {"ring": np.asarray(jax.jit(ring)(q, k, v, valid)),
                                   "oracle": np.asarray(want),
                                   "oracle_grads": [np.asarray(g) for g in grads]}

    seq = Mesh(np.asarray(jax.devices()[:C.WORLD]), ("seq",))
    cfg = C.stack_config(jax_tiny)
    x, pos = C.hidden_inputs(cfg, C.STACK_B, C.STACK_T)
    mask = jnp.ones((C.STACK_B, C.STACK_T), jnp.int32)
    out["ring_stack"] = np.asarray(jax.jit(lambda p, e: j_forward(
        p, e, jnp.asarray(pos), cfg.text_config, kv_valid_mask=mask,
        ring=(seq, "seq")).last_hidden_state)(_jparams(cfg), jnp.asarray(x)))

    # Activation sequence sharding: tests/test_seq_sharding.py's mesh.
    x, pos = C.hidden_inputs(cfg, C.SEQ_B, C.SEQ_T)
    dm = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    hs = NamedSharding(dm, P("data", "model", None))
    out["seq"] = np.asarray(jax.jit(lambda p, e: j_forward(
        p, e, jnp.asarray(pos), cfg.text_config, hidden_sharding=hs).last_hidden_state)(
        _jparams(cfg), jax.device_put(jnp.asarray(x), NamedSharding(dm, P("data", None, None)))))

    # The pipeline, and the plain forward's gradients of sum(h · w).
    pcfg = C.pipe_config(jax_tiny)
    pparams = _jparams(pcfg)

    co = jnp.asarray(C.pipe_cotangent(pcfg))

    def plain(layers, e, pos):
        h = j_forward({**pparams, "layers": layers}, e, pos, pcfg.text_config).last_hidden_state
        return jnp.sum(h * co), h

    plain_grad = jax.jit(jax.value_and_grad(plain, argnums=(0, 1), has_aux=True))
    for stages, n_micro in C.PIPE_CASES:
        x, pos = (jnp.asarray(a) for a in C.hidden_inputs(pcfg, C.PIPE_B, C.PIPE_T))
        pm = Mesh(np.asarray(jax.devices()[:stages]), ("pipe",))
        piped = jax.jit(lambda l, n, x, pos, pm=pm, n_micro=n_micro: j_pipeline(
            l, n, x, pos, pcfg.text_config, pm, n_micro=n_micro))(
            pparams["layers"], pparams["norm"], x, pos)
        (_, h), (gl, gx) = plain_grad(pparams["layers"], x, pos)
        out[("pipe", stages, n_micro)] = {"pipeline": np.asarray(piped), "plain": np.asarray(h),
                                          "layer_grads": gl, "dx": np.asarray(gx)}

    # The DCMoE block with token_drop on the whole batch.
    for policy in C.DROP_POLICIES:
        dcfg = C.drop_config(policy, jax_tiny)
        moe = jax.tree.map(lambda a: a[0], _jparams(dcfg)["layers"]["moe"])
        o = jax.jit(lambda p, x, dcfg=dcfg: j_block(p, x, dcfg.text_config, training=True,
                                                    rng=jax.random.PRNGKey(0)))(
            moe, jnp.asarray(C.drop_inputs(dcfg)))
        out[("drop", policy)] = {"hidden": np.asarray(o.hidden_states),
                                 "mask": np.asarray(o.expert_mask)}
    return out


def _single_references():
    """The port on one process: the mesh-less trainer's two steps (full
    batch and 3 rows), the unsharded loss gradients, the unsplit block."""
    from unimoe_audio_torch.moe.block import dcmoe_block
    from unimoe_audio_torch.train.step import loss_fn, named_leaves
    from unimoe_audio_torch.train.trainer import Trainer

    out = {}
    cfg = C.train_config()
    tr = Trainer(cfg, C.port_params(cfg), C.trainer_config(), device="cpu")
    out["train"] = C.two_steps(tr, cfg)
    tr = Trainer(cfg, C.port_params(cfg), C.trainer_config(), device="cpu")

    class Rows:
        def fit(self, batches, **kw):
            return tr.fit([{k: v[:C.REPLICATED_ROWS] for k, v in b.items()} for b in batches],
                          **kw)

        def whole_params(self):
            return tr.whole_params()

    out["replicated"] = C.two_steps(Rows(), cfg)

    lcfg = C.loss_config()
    params = C.port_params(lcfg)
    leaves = [t.requires_grad_() for _, t in named_leaves(params)]
    batch = {k: torch.tensor(v) for k, v in C.train_batch(lcfg).items()}
    loss, _ = loss_fn(params, lcfg, batch, 1, 0.025, remat=False)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    out["seq_loss"] = float(loss.detach())
    out["seq_grads"] = params_to_numpy(C.rebuild(
        params, [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, gs)]))
    for policy in C.DROP_POLICIES:
        dcfg = C.drop_config(policy)
        moe = C.port_params(dcfg)["layers"][0]["moe"]
        with torch.no_grad():
            o = dcmoe_block(moe, torch.tensor(C.drop_inputs(dcfg)), dcfg.text_config,
                            training=True, seed=0)
        out[("drop", policy)] = {"hidden": o.hidden_states.numpy(),
                                 "mask": o.expert_mask.numpy()}
    return out


def _flat(tree):
    """(name, array) of a port numpy tree (JAX layout), in key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            for n, a in _flat(v):
                yield (f"{k}/{n}" if n else k), a
    else:
        yield "", np.asarray(tree)


def _close_trees(got, want, **tol):
    """Two numpy trees of the JAX layout, leaf by leaf by name."""
    got, want = dict(_flat(got)), dict(_flat(want))
    assert set(got) == set(want) and len(got) > 10, (sorted(got), sorted(want))
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], err_msg=name, **tol)


# -- ring attention ----------------------------------------------------------------

@pytest.mark.parametrize("shape", C.RING_SHAPES, ids=lambda s: "B%d_H%d_KV%d_T%d_pad%d" % s)
def test_ring_attention_matches_jax_and_oracle(ranks, shape):
    """The chunks of four ranks, gathered, equal JAX's ring over four
    devices and the unsharded oracle (a row of the padded case attends no
    key and gives 0); the q, k and v gradients equal the oracle's."""
    got, want = ranks.results()[("ring_op", shape)], ranks.jax[("ring_op", shape)]
    np.testing.assert_allclose(got["out"], want["ring"], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got["out"], want["oracle"], rtol=2e-5, atol=2e-6)
    if shape[-1]:
        assert not got["out"][0, :, 0].any()                 # the wholly masked row
    for name, g in zip("qkv", want["oracle_grads"]):
        np.testing.assert_allclose(got[f"d{name}"], g, rtol=3e-5, atol=3e-6, err_msg=f"d{name}")


def test_ring_full_stack_matches_jax(ranks):
    np.testing.assert_allclose(ranks.results()["ring_stack"], ranks.jax["ring_stack"],
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("jax_ring", ["plain", "ring"])
def test_ring_loss_fn_matches_jax(ranks, jax_ring):
    """loss_fn with the ring over four ranks against JAX's loss_fn with and
    without its ring (jitter off); the gradients are the same on every
    rank, bit for bit."""
    got = ranks.results()["ring_loss"]
    loss, grads = ranks.jax[("ring_loss", jax_ring)]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    _close_trees(got["grads"], grads, atol=3e-5, rtol=2e-4)
    for r in range(1, C.WORLD):
        other = ranks.results(r)["ring_loss"]
        assert other["loss"] == got["loss"]
        for (name, a), (_, b) in zip(_flat(other["grads"]), _flat(got["grads"])):
            np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("shape", C.RING_TRAIN_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_trainer_ring_axis_matches_one_device(ranks, shape):
    """Trainer(ring_axis="model"): the ring over the model ranks, the rows
    over (data, expert), the weights whole on every rank."""
    got = ranks.results()[("ring_train", shape)]
    hist, params = ranks.single["train"]
    np.testing.assert_allclose(got["loss"], [h["loss"] for h in hist], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], [h["grad_norm"] for h in hist], rtol=1e-3)
    _assert_params_close(got["params"], params, params_to_numpy(C.port_params(
        C.train_config())), 1e-3)
    cfg = C.train_config().text_config
    assert got["q_width"] == (cfg.hidden_size, cfg.num_attention_heads * cfg.head_dim)
    for r in range(1, C.WORLD):
        np.testing.assert_array_equal(ranks.results(r)[("ring_train", shape)]["loss"],
                                      got["loss"])


# -- activation sequence sharding --------------------------------------------------

def test_seq_sharded_forward_matches_jax(ranks):
    """B over data, T over model, with tensor parallelism: the hidden
    states equal JAX's hidden_sharding forward."""
    np.testing.assert_allclose(ranks.results()["seq"]["hidden"], ranks.jax["seq"],
                               rtol=3e-4, atol=3e-5)


def test_seq_sharded_gradients_match_unsharded(ranks):
    """The loss and every gradient (the norms' weights, summed over the
    model ranks, included) equal the unsharded port's."""
    got = ranks.results()["seq"]
    np.testing.assert_allclose(got["loss"], ranks.single["seq_loss"], rtol=1e-5)
    names = [n for n, _ in _flat(got["grads"])]
    assert any("layernorm" in n for n in names) and "norm" in names
    _close_trees(got["grads"], ranks.single["seq_grads"], atol=3e-5, rtol=2e-4)


# -- pipeline ----------------------------------------------------------------------

@pytest.mark.parametrize("case", C.PIPE_CASES, ids=lambda c: "S%d_micro%d" % c)
def test_pipeline_matches_jax_and_plain(ranks, case):
    """The hidden states on every rank equal JAX's pipeline_forward and
    the plain forward; each stage's layer gradients, gathered, and the
    input gradient equal the plain forward's."""
    stages, n_micro = case
    want = ranks.jax[("pipe", stages, n_micro)]
    for r in range(C.WORLD):
        got = ranks.results(r)[("pipe", stages, n_micro)]
        np.testing.assert_allclose(got["hidden"], want["pipeline"], rtol=3e-4, atol=3e-5)
        np.testing.assert_allclose(got["hidden"], want["plain"], rtol=3e-4, atol=3e-5)
    got = ranks.results()[("pipe", stages, n_micro)]
    np.testing.assert_allclose(got["dx"], want["dx"], rtol=3e-4, atol=3e-5)
    from unimoe_audio_torch.train.step import named_leaves

    names = [n for n, _ in named_leaves(C.port_params(C.pipe_config())["layers"][0])]
    assert len(names) == len(jax.tree.leaves(want["layer_grads"]))
    assert len(got["layer_grads"]) == C.PIPE_LAYERS
    for i, layer in enumerate(got["layer_grads"]):
        for name, g in zip(names, layer):
            w = want["layer_grads"]
            for k in name.split("/"):
                w = w[k]
            np.testing.assert_allclose(g, np.asarray(w)[i], rtol=3e-4, atol=3e-5,
                                       err_msg=f"layer {i} {name}")


# -- the replicated batch and token_drop -------------------------------------------

def test_replicated_batch_matches_one_device_and_jax(ranks):
    """3 rows on (2, 2, 1) do not divide over the 4 (data, expert) ranks:
    every rank runs them whole, as JAX's trainer replicates them; the steps
    equal the mesh-less trainer's and JAX's on the same mesh."""
    got = ranks.results()["replicated"]
    hist, params = ranks.single["replicated"]
    jhist = ranks.jax["replicated"]
    np.testing.assert_allclose(got["loss"], [h["loss"] for h in hist], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], [h["grad_norm"] for h in hist], rtol=1e-3)
    np.testing.assert_allclose(got["loss"], [h["loss"] for h in jhist], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], [h["grad_norm"] for h in jhist], rtol=1e-3)
    _assert_params_close(got["params"], params, params_to_numpy(C.port_params(
        C.train_config())), 1e-3)


@pytest.mark.parametrize("policy", C.DROP_POLICIES)
def test_token_drop_on_split_batch_matches_jax(ranks, policy):
    """Each expert's keep-cut over the whole batch's tokens: the split
    block's output and expert mask equal the unsplit port block's and JAX's
    dcmoe_block; the cut drops tokens."""
    got = ranks.results()[("drop", policy)]
    one, want = ranks.single[("drop", policy)], ranks.jax[("drop", policy)]
    B, T = C.DROP_B, C.DROP_T
    np.testing.assert_array_equal(got["mask"], one["mask"])
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_allclose(got["hidden"].reshape(B, T, -1), one["hidden"], atol=1e-5)
    np.testing.assert_allclose(got["hidden"].reshape(B, T, -1), want["hidden"], atol=1e-5)
    cfg = C.drop_config(policy).text_config
    E = cfg.num_dynamic_experts
    assert got["mask"][:, :E].sum(0).max() <= _cap(cfg, B * T, E) < B * T


def _cap(cfg, S, E):
    from unimoe_audio_torch.moe.router import expert_capacity

    return expert_capacity(S, E, cfg.capacity_factor, cfg.min_capacity)


# -- refusals ----------------------------------------------------------------------

def test_refusals_on_ranks(ranks):
    """As JAX asserts: layers that do not split into the stages, a batch
    that does not split into the microbatches; and a ring axis the trainer
    does not carry."""
    got = ranks.results()["refusals"]
    assert "stages" in got["layers"]
    assert "microbatches" in got["micro"]
    assert "'data'" in got["axis"]


def test_refusals_in_one_process():
    """Ring attention with a cache and on a sliding layer, the pipeline on
    a sliding model, ring_axis without a mesh."""
    from unimoe_audio_torch.models.layers import attention
    from unimoe_audio_torch.parallel.pipeline import pipeline_forward
    from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig

    cfg = C.stack_config(use_sliding_window=True, sliding_window=4,
                         layer_types=("sliding_attention", "full_attention"))
    params = C.port_params(cfg)
    tc = cfg.text_config
    attn = params["layers"][0]["attn"]
    x = torch.zeros(1, 4, tc.hidden_size)
    cos = sin = torch.zeros(1, 4, tc.head_dim)
    cache = torch.zeros(8, 1, tc.num_key_value_heads, tc.head_dim)
    with pytest.raises(ValueError, match="no cache"):
        attention(attn, x, cos, sin, tc, cache_kv=(cache, cache), cache_position=0,
                  ring=_one_rank())
    with pytest.raises(ValueError, match="window"):
        attention(attn, x, cos, sin, tc, is_sliding=True, ring=_one_rank())
    xe, pos = C.hidden_inputs(cfg, 2, 4)
    with pytest.raises(ValueError, match="sliding"):
        pipeline_forward(params["layers"], params["norm"], torch.tensor(xe), torch.tensor(pos),
                         tc, None)
    with pytest.raises(ValueError, match="mesh"):
        Trainer(cfg, params, TrainerConfig(ring_axis="model"), device="cpu")


def _one_rank():
    """A ring of one rank: (mesh, axis) of a mesh whose axis has no group."""
    from types import SimpleNamespace

    return SimpleNamespace(group=lambda axis: None), "model"
