"""The port's parallel paths on the CPU, held to the JAX package's
`tests/test_parallel.py`, `tests/test_multihost.py`, the EP case of
`tests/test_dispatch.py` and the mesh serving of `tests/test_serve.py`.

Four gloo ranks (`tests/torch_mesh_worker.py`) start once for the file, in
a module-scoped fixture, through `maybe_initialize_multihost` with an
explicit coordinator address, process count and id; they run every case in
turn and hand back numpy results, which the parametrised tests read:

  * sharded training steps on the meshes (2, 2, 1), (2, 1, 2), (1, 2, 2) and
    (1, 1, 4): losses of two steps within rtol 1e-4 of the port's
    single-device steps and the first of the JAX single-device
    `train_step`, gradient norms within rtol 1e-3, the parameters after a
    step within atol 3e-6 of one device's; input jitter drawn over the
    whole batch;
  * FSDP at (2, 2, 1): every moment of at least 1 KiB on one data rank's
    slice (at least 10 of them), before and after the steps, the loss
    within rtol 2e-4; the FSDP specs equal `add_fsdp_axis`'s;
  * `moe_ffn_ep` and `ep_capacity(axis_name=...)` on expert groups of 2
    and 4, against the JAX functions inside `shard_map` on the same split;
  * `build_server(ep_size=2, tp_size=2)`: greedy codes equal to one
    device's (f32, int8, int4, the int8 KV cache; bf16 by its logits) and
    to the JAX package's generation over the same weights (`JAX_SERVE`: its
    (1, 2, 2) mesh for int8 with the int8 cache);
  * the training CLI with `--ep_size 2 --fsdp` at world size 2: the JAX
    CLI's metric rows on two of the harness's virtual devices.

The JAX side runs in this process on the harness's 8 virtual CPU devices
while the ranks work.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_mesh_cases as C
from unimoe_audio_torch.core.bridge import params_to_numpy
from unimoe_audio_torch.ops.quant import QTensor, pack_int4, qvalues, quantize_tensor_int4
from unimoe_audio_torch.parallel import mesh as TMESH
from unimoe_audio_torch.parallel.multihost import add_multihost_args, maybe_initialize_multihost
from tests.torch_threads import one_torch_thread  # noqa: F401

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mesh_worker.py")
REPO = os.path.dirname(os.path.dirname(WORKER))
LOSS_RTOL = 1e-5          # tests/test_torch_train_cli.py's


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
        """The four ranks, and the JAX CLI on two virtual devices beside
        them; one hash seed for all (the development tokenizer's ids come
        from `hash()`)."""
        a4, a2 = _addr(), _addr()
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update(PYTHONPATH=REPO, PYTHONHASHSEED="0", HF_HUB_OFFLINE="1",
                   TRANSFORMERS_OFFLINE="1")
        for r in range(4):
            log = open(os.path.join(self.base, f"log{r}.txt"), "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, WORKER, str(r), a4, a2, self.base], stdout=log,
                stderr=subprocess.STDOUT, env=env, cwd=REPO))
        argv = C.cli_argv(self.base, os.path.join(self.base, "cli_jax")) + [
            "--ep_size", "2", "--fsdp"]
        code = ("import sys, jax\n"
                "jax.config.update('jax_platforms', 'cpu')\n"
                "from unimoe_audio_tpu.train import cli\n"
                f"sys.exit(cli.main({argv!r}))\n")
        env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   JAX_PLATFORMS="cpu")
        self.jax_cli = subprocess.Popen(
            [sys.executable, "-c", code], stdout=open(os.path.join(self.base, "log_jax.txt"), "w"),
            stderr=subprocess.STDOUT, env=env, cwd=REPO)
        self.procs.append(self.jax_cli)

    def results(self, rank: int = 0):
        if self._res is None:
            for p in self.procs:
                p.wait(timeout=600)
            logs = [open(os.path.join(self.base, f)).read()[-3000:]
                    for f in ["log0.txt", "log1.txt", "log2.txt", "log3.txt", "log_jax.txt"]]
            assert all(p.returncode == 0 for p in self.procs), "\n".join(logs)
            self._res = [pickle.load(open(os.path.join(self.base, f"rank{r}.pkl"), "rb"))
                         for r in range(4)]
        return self._res[rank]

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks, started once: they need the CLI's model directory
    and its text-only data set (6 rows) first."""
    from examples.make_sample_dataset import build as build_sample_dataset

    base = str(tmp_path_factory.mktemp("mesh"))
    model, data = C.cli_paths(base)
    build_sample_dataset(data, n=6)
    cfg = C.train_config()
    os.makedirs(model)
    cfg.save_json(os.path.join(model, "config.json"))
    with open(os.path.join(model, "model.jax.pkl"), "wb") as f:
        pickle.dump({"params": params_to_numpy(C.port_params(cfg)), "config": cfg.to_dict()}, f)
    r = Ranks(base)
    r.start()
    try:
        # The references, computed while the ranks work.
        r.single = _single()
        r.jax_step = _jax_step()
        r.jax_ep = {shape: _jax_ep(shape[1]) for shape in C.EP_MESHES}
        r.jax_codes = {name: _jax_codes(name) for name in JAX_SERVE}
        yield r
    finally:
        r.stop()


# -- references ------------------------------------------------------------------

def _single():
    """The port's single-device runs of the training cases (jitter off and
    on): metrics rows and the params after the steps."""
    from unimoe_audio_torch.train.trainer import Trainer

    out = {}
    for jitter in (False, True):
        cfg = C.train_config(jitter)
        tr = Trainer(cfg, C.port_params(cfg), C.trainer_config(), device="cpu")
        out[jitter] = C.two_steps(tr, cfg)
    return out


def _jax_step():
    """The JAX package's single-device train_step on the same weights and
    batch: (loss, grad_norm) of the first step."""
    from unimoe_audio_tpu.config import tiny_test_config as jax_tiny
    from unimoe_audio_tpu.train.step import init_train_state, make_optimizer, train_step

    cfg = C.train_config(make=jax_tiny)
    params = jax.tree.map(jnp.asarray, params_to_numpy(C.port_params(C.train_config())))
    opt = make_optimizer(learning_rate=1e-3, total_steps=10, warmup_steps=0)
    batch = {k: jnp.asarray(v) for k, v in C.train_batch(cfg).items()}
    _, m = jax.jit(lambda s, b, r: train_step(s, b, r, cfg=cfg, optimizer=opt))(
        init_train_state(params, opt), batch, jax.random.PRNGKey(1))
    return float(m["loss"]), float(m["grad_norm"])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix, np.asarray(tree)


def _assert_params_close(got, want, init, lr, atol=3e-6):
    """got and want after one AdamW step from init.  That step moves a
    weight by lr·|g| / (|g| + 1e-8): where one device moved it by less than
    0.9·lr its gradient is below 1e-7, and the f32 rounding of the sums
    decides the move (a key bias's gradient, for one, is 0 in exact
    arithmetic); there the two agree to 2·lr, elsewhere to atol."""
    for (name, g), (name2, w), (_, p0) in zip(_flat(got), _flat(want), _flat(init)):
        assert name == name2 and g.shape == w.shape, (name, name2, g.shape, w.shape)
        noise = np.abs(w - p0) < 0.9 * lr
        np.testing.assert_allclose(g[~noise], w[~noise], atol=atol, err_msg=name)
        np.testing.assert_allclose(g[noise], w[noise], atol=2 * lr, err_msg=name)


def _init(jitter=False):
    return params_to_numpy(C.port_params(C.train_config(jitter)))


# -- multihost ---------------------------------------------------------------------

def test_multihost_arg_plumbing():
    """--coordinator-address / --num-processes / --process-id reach the
    initializer (injectable), as `tests/test_parallel.py:133`."""
    import argparse

    parser = argparse.ArgumentParser()
    add_multihost_args(parser)
    calls = []
    assert not maybe_initialize_multihost(parser.parse_args([]),
                                          initialize=lambda **kw: calls.append(kw))
    assert calls == []
    assert maybe_initialize_multihost(parser.parse_args(["--multihost"]),
                                      initialize=lambda **kw: calls.append(kw))
    assert calls == [{}]
    args = parser.parse_args(["--coordinator-address", "10.0.0.1:1234", "--num-processes", "4",
                              "--process-id", "2"])
    assert maybe_initialize_multihost(args, initialize=lambda **kw: calls.append(kw))
    assert calls[-1] == {"coordinator_address": "10.0.0.1:1234", "num_processes": 4,
                         "process_id": 2}


# -- training ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", C.TRAIN_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_sharded_steps_match_single_device_and_jax(ranks, shape):
    got = ranks.results()[("train", shape)]
    hist, params = ranks.single[False]
    np.testing.assert_allclose(got["loss"], [h["loss"] for h in hist], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"], [h["grad_norm"] for h in hist], rtol=1e-3)
    np.testing.assert_allclose(got["loss"][0], ranks.jax_step[0], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"][0], ranks.jax_step[1], rtol=1e-3)
    _assert_params_close(got["params"], params, _init(), 1e-3)
    # Every rank holds the same whole model after the gather.
    for r in range(1, 4):
        np.testing.assert_array_equal(ranks.results(r)[("train", shape)]["loss"], got["loss"])


def test_jitter_drawn_over_the_whole_batch(ranks):
    """Input jitter on: each rank draws the whole batch's noise and takes
    its rows, so the sharded steps equal one device's."""
    got = ranks.results()[("train_jitter", C.JITTER_MESH)]
    hist, params = ranks.single[True]
    assert hist[0]["loss"] != ranks.single[False][0][0]["loss"]
    np.testing.assert_allclose(got["loss"], [h["loss"] for h in hist], rtol=1e-4)
    _assert_params_close(got["params"], params, _init(), 1e-3)


def test_fsdp_shards_moments_and_matches(ranks):
    got = ranks.results()["fsdp"]
    hist, params = ranks.single[False]
    np.testing.assert_allclose(got["loss"], [h["loss"] for h in hist], rtol=2e-4)
    np.testing.assert_allclose(got["grad_norm"], [h["grad_norm"] for h in hist], rtol=1e-3)
    _assert_params_close(got["params"], params, _init(), 1e-3)
    L = C.train_config().text_config.num_hidden_layers
    n_split = 0
    for name, p_shape, before, after, d in got["moments"]:
        stacked = int(np.prod(p_shape)) * 4 * (L if name.startswith("layers/") else 1)
        if stacked < C.FSDP_MIN_BYTES * 2:   # the whole leaf is 2 x the rank's over expert
            continue
        if d is None:
            continue
        want = list(p_shape)
        want[d] //= 2
        assert before == after == tuple(want), (name, before, after, want)
        n_split += 1
    assert n_split >= 10


def test_fsdp_specs_equal_jax():
    """The port's add_fsdp_axis gives each leaf the JAX package's spec on a
    (2, 2, 1) and a (2, 2, 2) mesh (layer leaves without their stack dim)."""
    from jax.sharding import Mesh
    from unimoe_audio_tpu.config import tiny_test_config as jax_tiny
    from unimoe_audio_tpu.parallel import mesh as JMESH

    cfg = C.train_config()
    tparams = C.port_params(cfg)
    jparams = jax.tree.map(jnp.asarray, params_to_numpy(tparams))
    jcfg = C.train_config(make=jax_tiny)
    for shape in ((2, 2, 1), (2, 2, 2)):
        jm = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), JMESH.AXES)
        jspec = JMESH.add_fsdp_axis(JMESH.param_specs(jcfg), jparams, jm, min_bytes=1 << 10)
        tspec = TMESH.add_fsdp_axis(TMESH.param_specs(cfg), tparams,
                                    SimpleNamespace(shape=dict(zip(TMESH.AXES, shape))),
                                    min_bytes=1 << 10)
        jflat = {jax.tree_util.keystr(p): tuple(s) for p, s in
                 jax.tree_util.tree_flatten_with_path(
                     jspec, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}

        def norm(e):
            return tuple(e) if isinstance(e, (list, tuple)) else e

        n = 0
        for path, spec in jflat.items():
            keys = [k.strip("[]'\"") for k in path.split("][")]
            node = tspec
            for k in keys:
                node = node[k]
            want = tuple(norm(e) for e in spec)
            want = want + (None,) * (len(node) + (1 if keys[0] == "layers" else 0) - len(want))
            if keys[0] == "layers":
                want = want[1:]
            assert tuple(norm(e) for e in node) == want, (path, node, want)
            n += 1
        assert n == len(jflat) > 10


def test_local_shards_and_int4_split():
    """local_shard: column / row / expert splits, the kv heads a rank's q
    heads read when |model| > kv heads, and a packed int4 QTensor split along
    its packed dim equal to packing the split codes (scales split with
    their dim where it has more than one entry)."""
    cfg = C.serve_config().text_config
    w = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    m = SimpleNamespace(shape={"data": 1, "expert": 1, "model": 4},
                        coord={"data": 0, "expert": 0, "model": 3})
    assert torch.equal(TMESH.local_shard(w, (None, "model"), m), w[:, 24:])
    assert torch.equal(TMESH.local_shard(w, ("model", None), m), w[48:])
    assert TMESH.kv_replicas(cfg, 4) == 2 and TMESH.kv_replicas(cfg, 2) == 1
    # k_proj [D, KV·Dh] with 2 kv heads of 16 over 4 model ranks: rank 3
    # reads kv head 1.
    assert torch.equal(TMESH.local_shard(w, (None, "model"), m, kv_rep=2), w[:, 16:])
    q = quantize_tensor_int4(torch.randn(2, 64, 128, generator=torch.Generator().manual_seed(0)))
    assert q.q.dtype == torch.uint8
    got = TMESH.local_shard(q, ("expert", None, "model"), SimpleNamespace(
        shape={"data": 1, "expert": 2, "model": 2}, coord={"data": 0, "expert": 1, "model": 1}))
    want = qvalues(q)[1:, :, 64:]
    assert torch.equal(got.q, pack_int4(want)) and torch.equal(qvalues(got), want)
    assert torch.equal(got.s, q.s[1:, :, 64:])
    grouped = QTensor(q=torch.zeros(2, 64, 8, dtype=torch.int8), s=torch.ones(2, 4, 8))
    got = TMESH.local_shard(grouped, (None, "model", None), SimpleNamespace(
        shape={"data": 1, "expert": 1, "model": 2}, coord={"data": 0, "expert": 0, "model": 0}))
    assert got.q.shape == (2, 32, 8) and got.s.shape == (2, 2, 8)


# -- expert parallelism ------------------------------------------------------------

def _jax_ep(ep):
    """The JAX package's ep_capacity (a pmax) and moe_ffn_ep inside one
    shard_map over an expert axis of ep devices, on `ep_inputs` split by
    tokens and experts."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P
    from unimoe_audio_tpu.moe import dispatch as JD

    h, mask, w, params = C.ep_inputs()
    S_local = len(mask) // ep

    def body(hh, mm, ww, g, u, d):
        cap = JD.ep_capacity(mm, axis_name="expert")
        # S_local slots keep every token, as the synced capacity does (it is
        # at least each expert's load on each rank), with which the port runs.
        out = JD.moe_ffn_ep(hh, mm, ww, {"gate": g, "up": u, "down": d}, S_local,
                            axis_name="expert")
        return cap[None], out

    cap, out = shard_map(
        body, mesh=Mesh(np.asarray(jax.devices()[:ep]), ("expert",)),
        in_specs=(P("expert"),) * 6, out_specs=(P("expert"), P("expert")),
    )(*(jnp.asarray(a) for a in (h, mask, w, params["gate"], params["up"], params["down"])))
    return int(np.asarray(cap)[0]), np.asarray(out)


@pytest.mark.parametrize("shape", C.EP_MESHES, ids=lambda s: "ep%d" % s[1])
def test_moe_ffn_ep_matches_jax(ranks, shape):
    """moe_ffn_ep over an expert group of 2 (mesh 2 x 2 x 1) and of 4: the
    local tokens' outputs, gathered, equal the JAX package's; ep_capacity
    with axis_name is the group's largest expert load, as JAX's pmax."""
    ep = shape[1]
    cap, want = ranks.jax_ep[shape]
    mask = C.ep_inputs()[1]
    got = ranks.results()[("ep", shape)]
    assert got["capacity"] == cap == max(
        int(mask[i * len(mask) // ep:(i + 1) * len(mask) // ep].sum(0).max()) for i in range(ep))
    np.testing.assert_allclose(got["out"], want, atol=1e-5, rtol=0)


# -- mesh serving ------------------------------------------------------------------

# The JAX package's reference for the serving cases: its own (1, 2, 2)
# mesh (a GSPMD compile of the loop, about 11 s), for int8 weights with the
# int8 cache.  The port's single device, which the mesh is held to in every
# case, is held to the JAX package's single device in f32 and every
# serving mode by tests/test_torch_api.py and test_torch_generate.py.  (The
# JAX package's mesh moves 5 of the 1,280 f32 codes of unquantized weights
# from its own single device: GSPMD sums in another order at a greedy
# near-tie.)
JAX_SERVE = {"int8_kv": ((1, 2, 2), "int8", "int8")}


def _jax_codes(name):
    """The JAX package's greedy generation over the port's f32 weights
    (quantized by the JAX package, as the port quantizes them bit for bit),
    its params sharded on the case's mesh."""
    from jax.sharding import Mesh
    from unimoe_audio_tpu.config import tiny_test_config as jax_tiny
    from unimoe_audio_tpu.generate.loop import generate_jit, pad_buffer as j_pad
    from unimoe_audio_tpu.ops import quant as JQ
    from unimoe_audio_tpu.parallel import mesh as JMESH
    from unimoe_audio_torch.api import UniMoEAudio

    shape, mode, kv = JAX_SERVE[name]
    cfg = C.serve_config(make=jax_tiny)
    base = UniMoEAudio(allow_random=True, config=C.serve_config(), device="cpu",
                       dtype=torch.float32)
    jp = jax.tree.map(jnp.asarray, params_to_numpy(base.params))
    if mode:
        jp = JQ.pad_expert_ffn(JQ.quantize_model_params_inplace(jp))
        if mode == "int4":
            jp = JQ.requantize_experts_int4_inplace(jp)
    if shape is not None:
        jm = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape), JMESH.AXES)
        jp = JMESH.shard_params(jp, jm, cfg)
    ids, mask, prefill, steps = C.serve_inputs(base.config)
    base.serving_mode = mode
    kw = {**base.serving_dispatch(*ids.shape), "kv_dtype": kv}
    g = C.GREEDY
    res = generate_jit(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask), None, j_pad(prefill, C.SERVE_FRAMES),
        jnp.asarray(steps, jnp.int32), jax.random.PRNGKey(0), max_tokens=C.SERVE_FRAMES,
        min_tokens=jnp.int32(g["min_tokens"]), cfg_scale=jnp.float32(g["cfg_scale"]),
        temperature=jnp.float32(1.0), top_p=jnp.float32(1.0),
        cfg_filter_top_k=g["cfg_filter_top_k"], eos_prob_mul_factor=jnp.float32(1.0),
        do_sample=False, **kw)
    return np.asarray(res.codes)


# bf16: partial sums of the row-split products add in another order than
# one device's products, so bf16 codes part at near-ties; the prefill's
# codec logits agree within the bf16 drift (about 4e-2 of a 2-layer bf16
# prefill from f32, ROADMAP §3).  The quantized modes run the prefill's
# experts in packed_a8, where an activation within an ulp of a half step of
# its int8 grid rounds either way (tests/test_torch_api.py's bound).
BF16_LOGITS_REL_L2 = 4e-2
A8_LOGITS_REL_L2 = 1e-3


@pytest.mark.parametrize("name", list(C.SERVE_CASES))
def test_mesh_serving_matches_one_device(ranks, name):
    """build_server(ep_size=2, tp_size=2) on four ranks: each holds half
    the experts and half the q heads with the one kv head they read; every
    rank computes the same codes.  f32 and the quantized modes: codes equal
    to one device's and to the JAX package's (JAX_SERVE), prefill codec
    logits to 1e-5 (A8_LOGITS_REL_L2 under packed_a8); bf16: logits within
    BF16_LOGITS_REL_L2."""
    from unimoe_audio_torch.api import UniMoEAudio

    mode, kv, dtype = C.SERVE_CASES[name]
    one = UniMoEAudio(allow_random=True, config=C.serve_config(), device="cpu", dtype=dtype,
                      serving_mode=mode, kv_cache_dtype=kv, max_tokens=C.SERVE_FRAMES,
                      min_tokens=4)
    got = ranks.results()[("serve", name)]
    assert got["k_heads"] == (64, 16)        # one of 2 kv heads of 16 on each rank
    want_logits = C.prefill_logits(one)
    rel = np.linalg.norm(got["logits"] - want_logits) / np.linalg.norm(want_logits)
    if dtype == torch.bfloat16:
        assert rel < BF16_LOGITS_REL_L2, rel
    else:
        if mode:
            assert rel < A8_LOGITS_REL_L2, rel
        else:
            np.testing.assert_allclose(got["logits"], want_logits, rtol=1e-5, atol=1e-5)
        want = C.greedy_codes(one)
        np.testing.assert_array_equal(got["codes"], want)
        if name in ranks.jax_codes:
            np.testing.assert_array_equal(ranks.jax_codes[name], want)
    for r in range(1, 4):
        np.testing.assert_array_equal(ranks.results(r)[("serve", name)]["codes"], got["codes"])


# -- the training CLI ---------------------------------------------------------------

def test_cli_ep_fsdp_matches_jax_cli(ranks):
    """The port's CLI at world size 2 with --ep_size 2 --fsdp (its own
    multihost arguments) writes, on rank 0, the JAX CLI's metric rows with
    the same flags on two virtual devices; losses within LOSS_RTOL."""
    assert ranks.results(0)["cli"]["rc"] == ranks.results(1)["cli"]["rc"] == 0
    assert ranks.jax_cli.returncode == 0

    def rows(d):
        with open(os.path.join(ranks.base, d, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f.read().splitlines()]

    got, want = rows("cli_port"), rows("cli_jax")
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert sum("eval_loss" in r for r in got) >= 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("loss", "codec_loss", "aux_loss", "grad_norm", "eval_loss", "eval_aux_loss"):
            if k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)
    with open(os.path.join(ranks.base, "cli_port", "train_done.json")) as f:
        assert json.load(f) == {"steps": 2}


def test_four_ranks_start_and_sum(ranks):
    """The ranks joined one gloo group through maybe_initialize_multihost
    and summed across processes (`tests/test_multihost.py`'s ground)."""
    for r in range(4):
        assert ranks.results(r)["psum"] == [10.0, 10.0]
