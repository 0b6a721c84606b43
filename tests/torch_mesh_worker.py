"""One rank of the port's multi-process tests on the CPU (gloo), started
by `tests/test_torch_parallel.py`: `python tests/torch_mesh_worker.py RANK
ADDR4 ADDR2 OUT`.

The four ranks join a process group through `maybe_initialize_multihost`
(explicit coordinator address, process count and id) and run every case in
turn, each on a mesh of its own: training steps on four meshes, FSDP,
`moe_ffn_ep` and `ep_capacity` on expert groups of 2 and 4, mesh serving.
Then the group is torn down, ranks 0 and 1 run the training CLI at world
size 2 (`--ep_size 2 --fsdp`, its own multihost arguments) and every rank
pickles its numpy results to OUT/rank{r}.pkl.  The inputs come from
`tests/torch_mesh_cases.py`, which the test process reads too.
"""

import os
import pickle
import sys
import time
import traceback
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from tests import torch_mesh_cases as C  # noqa: E402
from unimoe_audio_torch.parallel import comm  # noqa: E402
from unimoe_audio_torch.parallel.mesh import (  # noqa: E402
    fsdp_dim, make_mesh, set_mesh, use_mesh)
from unimoe_audio_torch.parallel.multihost import maybe_initialize_multihost  # noqa: E402


def train_case(shape, *, fsdp=False, jitter=False):
    from unimoe_audio_torch.train.trainer import Trainer

    mesh = make_mesh(*shape, device="cpu")
    cfg = C.train_config(jitter)
    tr = Trainer(cfg, C.port_params(cfg), C.trainer_config(), device="cpu", mesh=mesh,
                 fsdp=fsdp, fsdp_min_bytes=C.FSDP_MIN_BYTES)
    before = [tuple(m.shape) for m in tr.state.opt_state.mu]
    hist, params = C.two_steps(tr, cfg)
    out = {"loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
           "params": params}
    if fsdp:
        out["moments"] = [
            (ls.name, tuple(p.shape), b, tuple(m.shape), fsdp_dim(ls.spec))
            for ls, (_, p), b, m in zip(tr.plan.leaves, _leaves(tr.state.params), before,
                                        tr.state.opt_state.mu)]
    return out


def _leaves(params):
    from unimoe_audio_torch.train.step import named_leaves

    return list(named_leaves(params))


def ep_case(shape):
    from unimoe_audio_torch.moe import dispatch as D

    mesh = make_mesh(*shape, device="cpu")
    ep, i = mesh.shape["expert"], mesh.coord["expert"]
    h, mask, w, params = C.ep_inputs()
    h, mask, w = torch.tensor(h), torch.tensor(mask), torch.tensor(w)
    S, E = mask.shape
    s0, s1 = i * S // ep, (i + 1) * S // ep
    El = E // ep
    local = {k: torch.tensor(v[i * El:(i + 1) * El]) for k, v in params.items()}
    with use_mesh(mesh, split_batch=True):
        cap = int(D.ep_capacity(mask[s0:s1], axis_name="expert"))
        out = D.moe_ffn_ep(h[s0:s1], mask[s0:s1], w[s0:s1], local, cap, axis_name="expert")
    return {"capacity": cap,
            "out": comm.all_gather_dim(out, mesh.group("expert"), 0).numpy()}


def serve_case(mode, kv, dtype):
    from unimoe_audio_torch.apps.serve import build_server

    model = build_server(None, ep_size=2, tp_size=2, allow_random=True, quantize=mode,
                         kv_cache=kv, config=C.serve_config(), device="cpu", dtype=dtype,
                         max_tokens=C.SERVE_FRAMES, min_tokens=4)
    try:
        heads = model.params["layers"][0]["attn"]["k_proj"]["w"]
        return {"codes": C.greedy_codes(model), "logits": C.prefill_logits(model),
                "k_heads": C.wshape_of(heads)}
    finally:
        set_mesh(None)


def cli_case(rank, addr, base):
    from unimoe_audio_torch.train import cli

    argv = C.cli_argv(base, os.path.join(base, "cli_port")) + [
        "--cpu", "--ep_size", "2", "--fsdp", "--coordinator-address", addr,
        "--num-processes", "2", "--process-id", str(rank)]
    return {"rc": cli.main(argv)}


def main() -> int:
    rank, addr4, addr2, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    res = {}
    args = SimpleNamespace(multihost=True, coordinator_address=addr4, num_processes=4,
                           process_id=rank)
    assert maybe_initialize_multihost(args, cpu=True)
    assert dist.get_world_size() == 4
    x = torch.full((2,), float(rank + 1))
    dist.all_reduce(x)
    res["psum"] = x.tolist()
    t0 = time.perf_counter()
    for shape in C.TRAIN_MESHES:
        res[("train", shape)] = train_case(shape)
    res[("train_jitter", C.JITTER_MESH)] = train_case(C.JITTER_MESH, jitter=True)
    res["fsdp"] = train_case(C.FSDP_MESH, fsdp=True)
    for shape in C.EP_MESHES:
        res[("ep", shape)] = ep_case(shape)
    t1 = time.perf_counter()
    for name, (mode, kv, dtype) in C.SERVE_CASES.items():
        res[("serve", name)] = serve_case(mode, kv, dtype)
    t2 = time.perf_counter()
    dist.barrier()
    dist.destroy_process_group()
    if rank < 2:
        res["cli"] = cli_case(rank, addr2, out)
        dist.destroy_process_group()
    print(f"seconds: training and ep {t1 - t0:.1f}, serving {t2 - t1:.1f}, "
          f"cli {time.perf_counter() - t2:.1f}", flush=True)
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
