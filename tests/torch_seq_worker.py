"""One rank of the port's sequence- and pipeline-parallel tests on the CPU
(gloo), started by `tests/test_torch_seq_parallel.py`: `python
tests/torch_seq_worker.py RANK ADDR OUT`.

The four ranks join one process group and run every case in turn: ring
attention with its gradients, the ring in the layer stack and in
`loss_fn`, the ring's row-for-chunk exchange, `Trainer(ring_axis=...)` on
every axis, activation sequence sharding,
the pipeline with its gradients, the refusals that need ranks, a batch
replicated over a mesh and `token_drop` on a split batch.  Every rank
pickles its numpy results to OUT/rank{r}.pkl.  The inputs come from
`tests/torch_seq_cases.py`, which the test process reads too.
"""

import os
import pickle
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tests import torch_seq_cases as C  # noqa: E402
from unimoe_audio_torch.core.bridge import params_to_numpy  # noqa: E402
from unimoe_audio_torch.parallel import comm  # noqa: E402
from unimoe_audio_torch.parallel.mesh import make_mesh, use_mesh  # noqa: E402
from unimoe_audio_torch.train.step import named_leaves  # noqa: E402


def _t(a):
    return torch.tensor(np.asarray(a))


def _grads(loss, tree):
    leaves = [t for _, t in named_leaves(tree)]
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [(torch.zeros_like(t) if g is None else g) for t, g in zip(leaves, gs)]


def ring_op(mesh, shape):
    """This rank's chunk through `ring_attention` over the model group of
    four; the chunks' outputs and q/k/v gradients gathered along T."""
    from unimoe_audio_torch.ops.ring_attention import ring_attention

    q, k, v, valid, co = (_t(a) for a in C.ring_inputs(*shape))
    g = mesh.group("model")
    n, r = comm.group_size(g), comm.group_rank(g)
    Tc = q.shape[2] // n
    cut = slice(r * Tc, (r + 1) * Tc)
    q, k, v = (t[:, :, cut].clone().requires_grad_() for t in (q, k, v))
    out = ring_attention(q, k, v, valid[:, cut], group=(mesh, "model"))
    grads = torch.autograd.grad((out * co[:, :, cut]).sum(), [q, k, v])
    return {"out": comm.all_gather_dim(out, g, 2).numpy(),
            **{f"d{n_}": comm.all_gather_dim(t, g, 2).numpy() for n_, t in zip("qkv", grads)}}


def ring_stack(mesh):
    from unimoe_audio_torch.models.model import text_model_forward

    cfg = C.stack_config()
    params = C.port_params(cfg)
    x, pos = C.hidden_inputs(cfg, C.STACK_B, C.STACK_T)
    mask = torch.ones(C.STACK_B, C.STACK_T, dtype=torch.int32)
    h = text_model_forward(params, _t(x), _t(pos), cfg.text_config, kv_valid_mask=mask,
                           ring=(mesh, "model")).last_hidden_state
    return h.detach().numpy()


def ring_loss(mesh):
    from unimoe_audio_torch.train.step import loss_fn

    cfg = C.loss_config()
    params = C.port_params(cfg)
    for _, t in named_leaves(params):
        t.requires_grad_(True)
    batch = {k: _t(v) for k, v in C.loss_batch(cfg).items()}
    loss, _ = loss_fn(params, cfg, batch, 1, 0.025, remat=False, ring=(mesh, "model"))
    grads = _grads(loss, params)
    return {"loss": float(loss.detach()), "grads": params_to_numpy(C.rebuild(params, grads))}


def ring_train(case):
    """Trainer(ring_axis=...) for two steps on the case's mesh: the metric
    rows, the whole params after the first step and the local q_proj
    width (whole without tensor parallelism, split over model with it)."""
    import dataclasses

    from tests.torch_mesh_cases import FSDP_MIN_BYTES
    from unimoe_audio_torch.train.trainer import Trainer

    shape, axis, fsdp, rows = case
    mesh = make_mesh(*shape, device="cpu")
    cfg = C.train_config()
    tcfg = dataclasses.replace(C.trainer_config(), ring_axis=axis)
    tr = Trainer(cfg, C.port_params(cfg), tcfg, device="cpu", mesh=mesh, fsdp=fsdp,
                 fsdp_min_bytes=FSDP_MIN_BYTES)
    hist, params = C.two_steps(_Rows(tr, rows) if rows else tr, cfg)
    return {"loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
            "params": params, "tp": tr.plan.model,
            "q_width": tuple(tr.state.params["layers"][0]["attn"]["q_proj"]["w"].shape)}


def exchange(groups):
    """comm.rows_to_chunks and chunks_to_rows over four and two ranks:
    the forward's output and x's gradient under a cotangent, the reverse's
    output (the round trip) and its input's gradient, an int32 mask's
    exchange, and the refusal of a T that does not split."""
    out = {}
    for p, rows, shape, dim in C.EXCHANGE_CASES:
        g = groups[p]
        r = comm.group_rank(g)
        x_all, mask_all, co_all, back_all = C.exchange_inputs(p, rows, shape, dim)
        x = _t(x_all[r]).requires_grad_()
        y = comm.rows_to_chunks(x, g, dim)
        gx, = torch.autograd.grad((y * _t(co_all[r])).sum(), x)
        y = y.detach().requires_grad_()
        back = comm.chunks_to_rows(y, g, dim)
        gy, = torch.autograd.grad((back * _t(back_all[r])).sum(), y)
        mask = comm.rows_to_chunks(_t(mask_all[r]), g, 1)
        try:
            comm.rows_to_chunks(x.detach().narrow(dim, 0, shape[dim - 1] - 1), g, dim)
            refused = None
        except ValueError as e:
            refused = str(e)
        out[p] = {"y": y.detach().numpy(), "gx": gx.numpy(), "back": back.detach().numpy(),
                  "gy": gy.numpy(), "mask": mask.numpy(), "mask_dtype": str(mask.dtype),
                  "refused": refused}
    return out


def seq_sharded():
    """Sequence parallelism on (2, 1, 2) with tensor parallelism: each data
    rank's row of the forward, and the loss's gradients summed over data
    and gathered over model (whole leaves)."""
    from unimoe_audio_torch.models.model import text_model_forward
    from unimoe_audio_torch.parallel.mesh import gather_params, shard_params
    from unimoe_audio_torch.train.step import loss_fn

    mesh = make_mesh(*C.SEQ_MESH, device="cpu")
    cfg = C.stack_config()
    local = shard_params(C.port_params(cfg), mesh, cfg)
    x, pos = C.hidden_inputs(cfg, C.SEQ_B, C.SEQ_T)
    n, d = mesh.shape["data"], mesh.coord["data"]
    b = C.SEQ_B // n
    with use_mesh(mesh, split_batch=True):
        h = text_model_forward(local, _t(x[d * b:(d + 1) * b]), _t(pos[:, d * b:(d + 1) * b]),
                               cfg.text_config, seq_axis="model").last_hidden_state
    out = {"hidden": comm.all_gather_dim(h, mesh.group("data"), 0).numpy()}
    lcfg = C.loss_config()
    local = shard_params(C.port_params(lcfg), mesh, lcfg)
    for _, t in named_leaves(local):
        t.requires_grad_(True)
    batch = C.train_batch(lcfg)
    b = len(batch["input_ids"]) // n
    batch = {k: _t(v[d * b:(d + 1) * b]) for k, v in batch.items()}
    with use_mesh(mesh, split_batch=True):
        loss, _ = loss_fn(local, lcfg, batch, 1, 0.025, remat=True, seq_axis="model")
        grads = _grads(loss, local)
    grads = [comm.all_reduce(g, mesh.group("data")) for g in grads]
    out["loss"] = float(loss.detach())
    out["grads"] = params_to_numpy(gather_params(C.rebuild(local, grads), mesh, lcfg))
    return out


def pipeline(groups, stages, n_micro):
    from unimoe_audio_torch.parallel.pipeline import pipeline_forward, stage_layers

    cfg = C.pipe_config()
    params = C.port_params(cfg)
    tc = cfg.text_config
    x, pos = C.hidden_inputs(cfg, C.PIPE_B, C.PIPE_T)
    group = groups[stages]
    mine = stage_layers(params["layers"], group)
    for lp in mine:
        for _, t in named_leaves(lp):
            t.requires_grad_(True)
    x = _t(x).requires_grad_()
    h = pipeline_forward(mine, params["norm"], x, _t(pos), tc, group, n_micro=n_micro,
                         staged=True)
    leaves = [t for lp in mine for _, t in named_leaves(lp)]
    grads = list(torch.autograd.grad((h * _t(C.pipe_cotangent(cfg))).sum(), leaves + [x]))
    # Every stage's layer gradients, in layer order, on every rank.
    n_leaves = len(list(named_leaves(mine[0])))
    per_stage = [comm.all_gather_dim(g[None], group, 0) for g in grads[:-1]]
    layers = []
    for s in range(stages):
        for i in range(len(mine)):
            layers.append([p[s].numpy() for p in per_stage[i * n_leaves:(i + 1) * n_leaves]])
    return {"hidden": h.detach().numpy(), "layer_grads": layers, "dx": grads[-1].numpy()}


def refusals(groups):
    """The refusals that need ranks: a layer count that does not split
    into the stages, a batch that does not split into the microbatches, and
    a ring axis that is not an axis of the mesh."""
    from unimoe_audio_torch.parallel.pipeline import pipeline_forward
    from unimoe_audio_torch.train.trainer import Trainer, TrainerConfig

    cfg = C.stack_config(num_hidden_layers=3)
    params = C.port_params(cfg)
    x, pos = C.hidden_inputs(cfg, 4, C.PIPE_T)
    out = {}
    for name, kw in (("layers", {"n_micro": 2}), ("micro", {"n_micro": 3})):
        try:
            layers = params["layers"] if name == "layers" else params["layers"][:2]
            pipeline_forward(layers, params["norm"], _t(x), _t(pos), cfg.text_config,
                             groups[2], **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    mesh = make_mesh(1, 1, 4, device="cpu")
    try:
        Trainer(cfg, params, TrainerConfig(ring_axis="seq"), device="cpu", mesh=mesh)
        out["axis"] = None
    except ValueError as e:
        out["axis"] = str(e)
    return out


def replicated():
    from unimoe_audio_torch.train.trainer import Trainer

    mesh = make_mesh(*C.REPLICATED_MESH, device="cpu")
    cfg = C.train_config()
    tr = Trainer(cfg, C.port_params(cfg), C.trainer_config(), device="cpu", mesh=mesh)
    hist, params = C.two_steps(_Rows(tr, C.REPLICATED_ROWS), cfg)
    return {"loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
            "params": params}


class _Rows:
    """A trainer whose fit takes the first `rows` rows of each batch."""

    def __init__(self, trainer, rows):
        self.trainer, self.rows = trainer, rows

    def fit(self, batches, **kw):
        return self.trainer.fit([{k: v[:self.rows] for k, v in b.items()} for b in batches], **kw)

    def whole_params(self):
        return self.trainer.whole_params()


def token_drop(policy):
    """The DCMoE block with token_drop on the batch's rows split over the
    four ranks: this rank's rows of the output and expert mask, gathered."""
    from unimoe_audio_torch.moe.block import dcmoe_block

    mesh = make_mesh(4, 1, 1, device="cpu")
    cfg = C.drop_config(policy)
    params = C.port_params(cfg)["layers"][0]["moe"]
    x = C.drop_inputs(cfg)
    r, b = mesh.coord["data"], C.DROP_B // 4
    with use_mesh(mesh, split_batch=True):
        out = dcmoe_block(params, _t(x[r * b:(r + 1) * b]), cfg.text_config, training=True,
                          seed=0)
    g = mesh.group("data")
    return {"hidden": comm.all_gather_dim(out.hidden_states, g, 0).numpy(),
            "mask": comm.all_gather_dim(out.expert_mask, g, 0).numpy()}


def main() -> int:
    rank, addr, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://{addr}", rank=rank,
                            world_size=C.WORLD)
    res = {}
    t0 = time.perf_counter()
    mesh = make_mesh(1, 1, 4, device="cpu")
    # Every rank creates every group, in the same order.
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    groups = {2: pairs[rank // 2], 4: dist.group.WORLD}
    for shape in C.RING_SHAPES:
        res[("ring_op", shape)] = ring_op(mesh, shape)
    res["ring_stack"] = ring_stack(mesh)
    res["ring_loss"] = ring_loss(mesh)
    t1 = time.perf_counter()
    res["exchange"] = exchange(groups)
    for case in C.RING_TRAIN_CASES:
        res[("ring_train", case)] = ring_train(case)
    res["seq"] = seq_sharded()
    t2 = time.perf_counter()
    for stages, n_micro in C.PIPE_CASES:
        res[("pipe", stages, n_micro)] = pipeline(groups, stages, n_micro)
    res["refusals"] = refusals(groups)
    t3 = time.perf_counter()
    res["replicated"] = replicated()
    for policy in C.DROP_POLICIES:
        res[("drop", policy)] = token_drop(policy)
    dist.barrier()
    dist.destroy_process_group()
    print(f"seconds: ring {t1 - t0:.1f}, the exchange, ring training and sequence sharding "
          f"{t2 - t1:.1f}, "
          f"pipeline {t3 - t2:.1f}, replicated batch and token_drop "
          f"{time.perf_counter() - t3:.1f}", flush=True)
    with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
