"""Device mesh and sharding rules of the port — counterpart of
`unimoe_audio_tpu/parallel/mesh.py`.

One (data, expert, model) grid of ranks, a `torch.distributed` DeviceMesh,
takes the place of the JAX package's `jax.sharding.Mesh`.  GSPMD inserts
the JAX package's collectives; the port writes them out
(`parallel/comm.py`):

  data    batch rows split; gradients summed over it (reduce-scattered
          under FSDP, where each large leaf's Adam moments and update live
          on one data rank's slice of it);
  expert  batch rows split as well, and the dynamic experts: training sends
          each token to its expert's rank and back (`moe_ffn_ep`, two
          all-to-alls); serving holds every token on every rank and sums the
          local experts' outputs over the group;
  model   attention heads and FFN intermediate dims: q/k/v and gate/up split
          by columns, o_proj and down by rows (an all-reduce after each),
          lm_head and codec_head by outputs (the logits all-gathered).

A spec has one entry per dim of a leaf: None, an axis name, or a tuple of
names (split by the first, then within that by the second).  The port's
layer leaves are per layer, so a layer leaf's spec is the JAX package's
without its layer-stack dim 0.  Parameters are stored split only over
`expert` and `model`: a `data` entry (FSDP, `add_fsdp_axis`) places the
optimizer state, not the weight, which every data rank keeps whole for its
forward (ZeRO-2).

Code inside `use_mesh(mesh)` runs on the mesh: the layers, the DCMoE block
and the heads read the active mesh (`active()`) and run the collectives;
with `split_batch=True` (the trainer) each rank holds its own rows of the
batch, and the losses, the load-balancing statistics and the jitter draws
are taken over the whole batch.
"""

from __future__ import annotations

import contextlib
import socket
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import UniMoEAudioConfig
from ..ops.quant import QTensor, is_int4, is_kmajor, kmajor, wshape
from . import comm

AXES = ("data", "expert", "model")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_single_process(device: str = "cuda") -> None:
    """A process group of one rank on a free localhost port (NCCL for
    "cuda", gloo for "cpu"), unless one runs already."""
    if dist.is_initialized():
        return
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                            world_size=1)


class Mesh:
    """The (data, expert, model) grid over every rank of the default
    process group, rank r at the row-major coordinate of r.  `groups[axes]`
    holds this rank's process group over those axes (the others fixed);
    `block_groups[r]`, for each r that divides |model| (1 < r < |model|),
    its group of r consecutive model ranks (the ranks that share a kv head
    when |model| > num_key_value_heads)."""

    def __init__(self, data: int, expert: int, model: int, device_type: str):
        from torch.distributed.device_mesh import init_device_mesh

        n = data * expert * model
        if dist.get_world_size() != n:
            raise ValueError(f"mesh {data} x {expert} x {model} needs {n} ranks, the process "
                             f"group has {dist.get_world_size()}")
        self.device_type = device_type
        self.device_mesh = init_device_mesh(device_type, (data, expert, model),
                                            mesh_dim_names=AXES)
        self.shape = {"data": data, "expert": expert, "model": model}
        self.rank = dist.get_rank()
        self.coord = dict(zip(AXES, (int(c) for c in np.unravel_index(self.rank,
                                                                        (data, expert, model)))))
        grid = np.arange(n).reshape(data, expert, model)
        self.groups = {(a,): self.device_mesh.get_group(a) for a in AXES}
        # Every rank creates every group, in the same order.
        for axes in (("data", "expert"),):
            keep = [AXES.index(a) for a in axes]
            rest = [i for i in range(3) if i not in keep]
            for idx in np.ndindex(*(grid.shape[i] for i in rest)):
                sl = [slice(None)] * 3
                for i, v in zip(rest, idx):
                    sl[i] = v
                ranks = sorted(int(r) for r in grid[tuple(sl)].reshape(-1))
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    self.groups[axes] = g
        self.groups[AXES] = dist.group.WORLD
        self.block_groups = {}
        for r in range(2, model):
            if model % r:
                continue
            for base in grid.reshape(-1, model):
                for b in range(0, model, r):
                    ranks = [int(x) for x in base[b:b + r]]
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        self.block_groups[r] = g

    def size(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else axes
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, axes) -> int:
        """This rank's position along axes (row-major over them)."""
        axes = (axes,) if isinstance(axes, str) else axes
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coord[a]
        return i

    def group(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return self.groups[axes] if self.size(axes) > 1 else None

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, expert={self.shape['expert']}, " \
               f"model={self.shape['model']}, {self.device_type})"


def make_mesh(data: int = 1, expert: int = 1, model: int = 1, *,
              device: str = "cuda") -> Mesh:
    """The mesh over the running process group (a one-rank group is
    started for a 1 x 1 x 1 mesh when none runs).  device "cuda" (NCCL) or
    "cpu" (gloo)."""
    if data * expert * model == 1:
        init_single_process(device)
    elif not dist.is_initialized():
        raise RuntimeError("a mesh of several ranks needs a process group: "
                           "parallel.multihost.maybe_initialize_multihost or torchrun")
    return Mesh(data, expert, model, device)


def default_mesh_shape(n_devices: int, ep_size: int = 1, tp_size: int = 1) -> Tuple[int, int, int]:
    """Factor n_devices into (data, expert, model)."""
    assert n_devices % (ep_size * tp_size) == 0
    return n_devices // (ep_size * tp_size), ep_size, tp_size


# -- the active mesh -----------------------------------------------------------

class MeshContext(NamedTuple):
    mesh: Mesh
    split_batch: bool
    tp: bool = True              # the layers split over the model axis


_ACTIVE: Optional[MeshContext] = None


def active() -> Optional[MeshContext]:
    return _ACTIVE


def set_mesh(mesh: Optional[Mesh], *, split_batch: bool = False,
             tp: bool = True) -> Optional[MeshContext]:
    """Make mesh the process's active mesh (None: none); returns the one it
    replaces.  A server keeps it for its life (`apps/serve.build_server`).
    tp=False: the layers hold whole weights and run no tensor parallelism
    over the model axis, which another use holds (ring attention's
    sequence, `TrainerConfig(ring_axis="model")`)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = None if mesh is None else MeshContext(mesh, split_batch, tp)
    return prev


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], *, split_batch: bool = False, tp: bool = True):
    prev = set_mesh(mesh, split_batch=split_batch, tp=tp)
    try:
        yield
    finally:
        global _ACTIVE
        _ACTIVE = prev


def tp_group():
    """The active mesh's model group (None without a mesh, with one model
    rank, or with tensor parallelism off)."""
    ctx = _ACTIVE
    return None if ctx is None or not ctx.tp else ctx.mesh.group("model")


def batch_group():
    """The group the batch rows are split over: (data, expert) of the
    active mesh under split_batch, else None."""
    ctx = _ACTIVE
    return ctx.mesh.group(("data", "expert")) if ctx is not None and ctx.split_batch else None


def kv_replicas(cfg, tp: int) -> int:
    """Model ranks that share one kv head: tp / num_key_value_heads when
    tp exceeds it (each rank then holds the one kv head its q heads use),
    else 1."""
    KV = cfg.num_key_value_heads
    if tp <= KV:
        if KV % tp:
            raise ValueError(f"{KV} kv heads do not split over {tp} model ranks")
        return 1
    if tp % KV or cfg.num_attention_heads % tp:
        raise ValueError(f"{cfg.num_attention_heads} q / {KV} kv heads do not split over "
                         f"{tp} model ranks")
    return tp // KV


# -- specs ---------------------------------------------------------------------

def param_specs(cfg: UniMoEAudioConfig) -> Dict:
    """The split of every leaf of `init_model_params`' tree (one spec for
    all layers), as `param_specs` in the JAX package: the q/k/v outputs and
    the experts' intermediate dims split over model (column), o_proj and
    down on their input dim (row), the heads on their outputs; the dynamic
    experts over expert.

    GQA: a rank holds the q heads of its model slice and the kv heads they
    read.  With |model| <= num_key_value_heads that is k/v's own column
    slice; above it each rank holds the one kv head its q heads use
    (`kv_replicas` ranks hold each), and the gradients of those copies are
    summed over the ranks that share them."""
    col = {"w": (None, "model"), "b": ("model",)}
    layer = {
        "input_layernorm": (None,),
        "post_attention_layernorm": (None,),
        "attn": {"q_proj": dict(col), "k_proj": dict(col), "v_proj": dict(col),
                 "o_proj": {"w": ("model", None)}},
        "moe": {
            "gate": (None, None),
            "dynamic": {"gate": ("expert", None, "model"), "up": ("expert", None, "model"),
                        "down": ("expert", "model", None)},
            "fixed": {"gate": (None, None, "model"), "up": (None, None, "model"),
                      "down": (None, "model", None)},
        },
    }
    return {"embed_tokens": (None, None), "layers": layer, "norm": (None,),
            "lm_head": (None, "model"), "codec_embed": (None, None, None),
            "codec_head": (None, "model")}


def _replicated(tree):
    if isinstance(tree, dict):
        return {k: _replicated(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_replicated(v) for v in tree]
    return tuple([None] * len(wshape(tree)))


def _drop_model(tree):
    if isinstance(tree, dict):
        return {k: _drop_model(v) for k, v in tree.items()}
    return tuple(None if e == "model" else e for e in tree)


def full_specs(params: Dict, cfg: UniMoEAudioConfig, *, model: bool = True) -> Dict:
    """`param_specs` with the vision tower and PEFT adapters replicated
    (`mesh.py:181-192`), in the key order of params.  model=False: no leaf
    split over the model axis (the weights whole on every model rank)."""
    specs = dict(param_specs(cfg) if model else _drop_model(param_specs(cfg)))
    for k in ("vision", "peft"):
        if k in params:
            specs[k] = _replicated(params[k])
    missing = set(params) - set(specs)
    if missing:
        raise ValueError(f"no sharding rule for {sorted(missing)}")
    return specs


class LeafSpec(NamedTuple):
    name: str
    spec: tuple            # one entry per dim
    kv_rep: int            # model ranks sharing this leaf's pieces (k/v under GQA), else 1


def leaf_specs(params: Dict, specs: Dict, cfg: UniMoEAudioConfig, tp: int) -> List[LeafSpec]:
    """One LeafSpec per leaf of params, in `train.step.named_leaves` order;
    a layer list shares its one spec."""
    kv = kv_replicas(cfg.text_config, tp)
    out: List[LeafSpec] = []

    def walk(p, s, name):
        if isinstance(p, dict):
            for k, v in p.items():
                if k not in s:
                    raise ValueError(f"no sharding rule for {name}/{k}")
                walk(v, s[k], f"{name}/{k}" if name else k)
        elif isinstance(p, list):
            for v in p:
                walk(v, s if isinstance(s, dict) else s[0], name)
        else:
            rep = kv if name.startswith("layers/attn/") and name.split("/")[2] in (
                "k_proj", "v_proj") else 1
            out.append(LeafSpec(name, tuple(s), rep))

    walk(params, specs, "")
    return out


def add_fsdp_axis(specs: Dict, params: Dict, mesh, *, min_bytes: int = 1 << 18) -> Dict:
    """`data` added to the spec of every leaf of at least min_bytes
    (`mesh.py:89-157`), with the JAX package's three passes over the leaf as
    that package stacks it (a layer leaf counts L times its bytes; its
    layer-stack dim 0 is never split):
      1. the largest non-last dim that has no split and divides by |data|;
      2. else 'data' stacked under an already split non-last dim, where
         jointly divisible;
      3. else, outside the layers only, the last dim.
    mesh: anything with a `shape` dict of the three axes."""
    data = int(mesh.shape.get("data", 1))
    axis_size = {a: int(mesh.shape[a]) for a in AXES}

    def upgrade(leaf, spec, n_layers):
        if isinstance(leaf, QTensor):
            itemsize, shape = 0.5 if is_int4(leaf) else leaf.q.element_size(), tuple(wshape(leaf))
        else:
            itemsize, shape = leaf.element_size(), tuple(leaf.shape)
        scanned = n_layers is not None
        if scanned:
            shape, spec = (n_layers,) + shape, (None,) + tuple(spec)
        if not shape or data <= 1 or np.prod(shape) * itemsize < min_bytes:
            return tuple(spec)[1:] if scanned else tuple(spec)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        start, last = (1 if scanned else 0), len(shape) - 1
        order = sorted(range(start, last), key=lambda j: -shape[j])
        done = False
        for i in order:                                           # pass 1
            if entries[i] is None and shape[i] % data == 0:
                entries[i], done = "data", True
                break
        if not done:
            for i in order:                                       # pass 2
                e = entries[i]
                if isinstance(e, str) and shape[i] % (axis_size[e] * data) == 0:
                    entries[i], done = (e, "data"), True
                    break
        if not done and not scanned:                              # pass 3
            e = entries[last]
            if e is None and shape[last] % data == 0:
                entries[last] = "data"
            elif isinstance(e, str) and shape[last] % (axis_size[e] * data) == 0:
                entries[last] = (e, "data")
        return tuple(entries[1:]) if scanned else tuple(entries)

    def walk(p, s, n_layers):
        if isinstance(p, dict):
            return {k: walk(v, s[k], n_layers) for k, v in p.items()}
        if isinstance(p, list):
            return walk(p[0], s, len(p)) if isinstance(s, dict) else [
                walk(v, sv, n_layers) for v, sv in zip(p, s)]
        return upgrade(p, s, n_layers)

    return walk(params, specs, None)


# -- placing and gathering -----------------------------------------------------

def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def storage_splits(spec: tuple) -> Iterator[Tuple[int, str]]:
    """(dim, axis) of the splits a parameter is stored with: expert and
    model, not data."""
    for d, e in enumerate(spec):
        for a in _axes(e):
            if a != "data":
                yield d, a


def fsdp_dim(spec: tuple) -> Optional[int]:
    for d, e in enumerate(spec):
        if "data" in _axes(e):
            return d
    return None


def _split(x: torch.Tensor, dim: int, n: int, i: int, rep: int) -> torch.Tensor:
    """Piece i of n along dim; with rep > 1, n / rep pieces, each held by
    rep consecutive ranks."""
    pieces = n // rep
    if x.shape[dim] % pieces:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into {pieces}")
    return x.chunk(pieces, dim)[i // rep]


def _own(x: torch.Tensor, kmaj: bool) -> torch.Tensor:
    """A tensor of its own (not a view of the whole leaf); K-major kept."""
    x = x.clone()
    return kmajor(x) if kmaj and not is_kmajor(x) else x


def local_shard(x, spec: tuple, mesh: Mesh, kv_rep: int = 1):
    """This rank's piece of a whole leaf (tensor or QTensor) under spec.
    A QTensor's q splits as the weight (packed int4 along its byte dim,
    whose code pairs never cross a split of an even width); its scale
    splits where its dim has more than one entry (a group-wise scale with
    its groups) and stays whole where it has one (`mesh.py:170-205`)."""
    splits = [(d, a) for d, a in storage_splits(spec) if mesh.shape[a] > 1]
    if not splits:
        return x
    if isinstance(x, QTensor):
        q, s = x.q, x.s
        kmaj = is_kmajor(q) and q.dim() >= 2
        for d, a in splits:
            n, i = mesh.shape[a], mesh.coord[a]
            rep = kv_rep if a == "model" else 1
            q = _split(q, d, n, i, rep)
            if s.shape[d] > 1:
                s = _split(s, d, n, i, rep)
        return QTensor(q=_own(q, kmaj), s=s.clone())
    for d, a in splits:
        x = _split(x, d, mesh.shape[a], mesh.coord[a], kv_rep if a == "model" else 1)
    return _own(x, False)


def _map_leaves(fn, params, specs: List[LeafSpec]):
    """params with each leaf replaced by fn(leaf, LeafSpec), in
    `leaf_specs` order."""
    it = iter(specs)

    def walk(p):
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        if isinstance(p, list):
            return [walk(v) for v in p]
        return fn(p, next(it))

    return walk(params)


def _tp(mesh: Mesh, model: bool) -> int:
    return mesh.shape["model"] if model else 1


def shard_params(params: Dict, mesh: Mesh, cfg: UniMoEAudioConfig, *,
                 model: bool = True) -> Dict:
    """This rank's shard of every leaf of a whole param tree (QTensor
    leaves included), per `param_specs`; the vision tower and PEFT adapters
    whole.  FSDP changes no parameter (see the module docstring): the
    trainer places the optimizer state by `add_fsdp_axis`
    (`Trainer(mesh=..., fsdp=True)`).  model=False: nothing split over the
    model axis (`full_specs`)."""
    ls = leaf_specs(params, full_specs(params, cfg, model=model), cfg, _tp(mesh, model))
    return _map_leaves(lambda x, s: local_shard(x, s.spec, mesh, s.kv_rep), params, ls)


def _gather(x: torch.Tensor, spec: LeafSpec, mesh: Mesh, scale_of=None) -> torch.Tensor:
    for d, a in reversed(list(storage_splits(spec.spec))):
        if scale_of is not None and scale_of.shape[d] == 1:
            continue
        g = comm.all_gather_dim(x, mesh.group(a), d)
        rep = spec.kv_rep if a == "model" else 1
        if rep > 1:
            g = torch.cat(g.chunk(mesh.shape[a], d)[::rep], dim=d)
        x = g
    return x


def gather_params(params: Dict, mesh: Mesh, cfg: UniMoEAudioConfig, *,
                  model: bool = True) -> Dict:
    """The whole tree from every rank's shard (`shard_params`' inverse), on
    every rank; gradient-free."""
    ls = leaf_specs(params, full_specs(params, cfg, model=model), cfg, _tp(mesh, model))

    def one(x, s):
        if isinstance(x, QTensor):
            return QTensor(q=_gather(x.q, s, mesh), s=_gather(x.s, s, mesh, scale_of=x.s))
        return _gather(x, s, mesh)

    return _map_leaves(one, params, ls)


def batch_spec() -> Tuple[str, str]:
    """Batches split over the data and expert axes together: every rank
    holds distinct rows (`mesh.py:218-222`)."""
    return ("data", "expert")


def kv_heads(params: Dict, cfg) -> int:
    """The kv heads a rank's attention holds: its cache's head count."""
    return int(wshape(params["layers"][0]["attn"]["k_proj"]["w"])[-1] // cfg.head_dim)
