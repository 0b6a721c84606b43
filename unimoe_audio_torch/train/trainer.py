"""Training loop of the port: the steps, metrics, evaluation, checkpoints
and resume, and the inference export — counterpart of
`unimoe_audio_tpu/train/trainer.py` for the paths this slice carries.
`Trainer.fit` is the entry point.

The trainer runs on the card (`device="cuda"`, the default) and raises
without one; the tests pass `device="cpu"`.  `Trainer(mesh=...)` trains on
a (data, expert, model) mesh of ranks (`parallel/mesh.py`, `MeshPlan`);
`TrainerConfig(ring_axis=...)` runs its attention as ring attention over
one axis of that mesh (`ops/ring_attention.py`).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import UniMoEAudioConfig
from ..core.bridge import params_to_numpy
from ..core.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..models.model import calculate_input_embedding, get_rope_index
from ..models.vision import vision_forward, vision_indices
from ..parallel import comm
from ..parallel.mesh import (AXES, Mesh, active, add_fsdp_axis, batch_spec, fsdp_dim,
                             full_specs, gather_params, leaf_specs, shard_params,
                             storage_splits, use_mesh)
from ..utils import profiling
from .step import aux_weight_at_step, init_train_state, loss_fn, make_optimizer, named_leaves, \
    place_batch, train_step


@dataclass
class TrainerConfig:
    """The JAX package's `TrainerConfig` (same names and defaults).
    `ring_axis` (an axis of the mesh, with `Trainer(mesh=...)`): the
    sequence shards over that axis in every attention (ring attention,
    `trainer.py:67-71, 218-226`).  "model": the ranks of that axis hold the
    same rows and the same whole weights (no tensor parallelism).  "data"
    or "expert": tensor parallelism stays on the model axis, and the ring's
    ranks, which hold different rows of the split batch, exchange their
    rows for chunks of the sequence around the attention
    (`models/layers.attention`).  `train_vision` runs
    the vision tower inside the step, so it trains (False: its features are
    fused outside the step and the tower stays as it is); `vision_bucket`
    pads the merged vision tokens of a batch to a multiple of it.
    `dispatch_mode` is 'dense', 'packed' (per-expert slot count
    `dispatch_capacity`, None = all tokens) or 'gmm'.  `grad_accum_steps` > 1 applies the optimizer every
    that many micro-steps, to their mean gradient; the step count, and with
    it the log and save cadences, counts micro-steps."""
    learning_rate: float = 1e-4
    weight_decay: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"
    grad_clip: float = 1.0
    log_every: int = 10
    save_every: int = 500
    ckpt_dir: Optional[str] = None
    max_to_keep: int = 3
    remat: bool = True
    dispatch_mode: str = "dense"
    dispatch_capacity: Optional[int] = None
    seed: int = 0
    grad_accum_steps: int = 1
    eval_every: int = 0
    trainable_pattern: Optional[str] = None
    train_vision: bool = True
    vision_bucket: int = 64
    ring_axis: Optional[str] = None


def compress_strings_set(strings):
    """Compact a set of dotted names by folding numeric components into
    ranges, e.g. {'layers.0.w', 'layers.1.w', 'layers.2.w', 'norm.w'} →
    {'layers.[0-2].w', 'norm.w'} (one numeric field per pass, repeated to a
    fixpoint).  Returns a set of compacted strings."""

    def fold_once(names):
        groups: Dict[str, list] = {}
        passthrough = []
        for s in names:
            parts = s.split(".")
            idx = next((i for i, p in enumerate(parts) if p.isdigit()), None)
            if idx is None:
                passthrough.append(s)
                continue
            key = ".".join(parts[:idx] + ["\x00"] + parts[idx + 1:])
            groups.setdefault(key, []).append(int(parts[idx]))
        out = list(passthrough)
        for key, vals in groups.items():
            vals.sort()
            spans, lo = [], vals[0]
            prev = lo
            for v in vals[1:]:
                if v != prev + 1:
                    spans.append((lo, prev))
                    lo = v
                prev = v
            spans.append((lo, prev))
            ranged = ",".join(str(a) if a == b else f"{a}-{b}" for a, b in spans)
            out.append(key.replace("\x00", f"[{ranged}]"))
        return out

    names = list(strings)
    while True:
        folded = fold_once(names)
        if len(folded) == len(names):
            return set(folded)
        names = folded


class MetricsLogger:
    """stdout + optional JSONL + optional wandb metrics sink.  wandb is used
    when use_wandb is True (fails if the package is missing), or when it is
    None and the package imports and one of WANDB_API_KEY / WANDB_PROJECT /
    WANDB_MODE is set."""

    def __init__(self, jsonl_path: Optional[str] = None, *,
                 use_wandb: Optional[bool] = None,
                 wandb_run_config: Optional[Dict[str, Any]] = None):
        self.jsonl_path = jsonl_path
        self._fh = open(jsonl_path, "a") if jsonl_path else None
        self._wandb = None
        env_on = any(os.environ.get(k) for k in ("WANDB_API_KEY", "WANDB_PROJECT", "WANDB_MODE"))
        if use_wandb or (use_wandb is None and env_on):
            try:
                import wandb  # type: ignore

                if wandb.run is None:
                    wandb.init(project=os.environ.get("WANDB_PROJECT", "unimoe-audio-torch"),
                               name=os.environ.get("WANDB_NAME") or None,
                               config=wandb_run_config or {})
                self._wandb = wandb
            except ImportError:
                if use_wandb:
                    raise
                print("[metrics] wandb env set but package unavailable — JSONL/stdout only")

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        flat = {k: float(v) for k, v in metrics.items()}
        print(f"step {step}: " + ", ".join(f"{k}: {v:.4g}" for k, v in flat.items()))
        if self._fh:
            self._fh.write(json.dumps({"step": step, **flat}) + "\n")
            self._fh.flush()
        if self._wandb is not None:
            self._wandb.log(flat, step=step)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None


class MeshPlan:
    """How a trainer on a mesh treats each leaf (`trainer.py:183-190,
    345-360`): the batch rows are split over (data, expert), so a leaf's
    gradient is summed over the ranks that hold the same piece of it —
    (data, expert) for a leaf whole over expert, data for an expert-split
    one, and also the model ranks that share a kv head's copy (GQA with
    |model| > num_key_value_heads).  Under FSDP a leaf with a `data` entry
    (`add_fsdp_axis`) is reduce-scattered to this data rank's slice instead,
    the optimizer keeps moments for that slice only and updates it, and the
    updated slices are all-gathered into the whole (local) parameter.  The
    gradient norm counts each distinct piece once.  model=False: no leaf is
    split over the model axis (ring attention holds it), and its ranks hold
    whole copies with equal gradients.  A ring over data or expert changes
    none of this: the exchange brings each rank's q, k and v gradients back
    to the rank whose rows made them, so a projection's gradient is still
    this rank's rows', summed over (data, expert) as without a ring."""

    def __init__(self, mesh: Mesh, params: Dict, cfg: UniMoEAudioConfig, *, fsdp: bool,
                 fsdp_min_bytes: int, model: bool = True):
        self.mesh = mesh
        self.model = model
        specs = full_specs(params, cfg, model=model)
        if fsdp:
            specs = add_fsdp_axis(specs, params, mesh, min_bytes=fsdp_min_bytes)
        self.leaves = leaf_specs(params, specs, cfg, mesh.shape["model"] if model else 1)
        world = mesh.size(("data", "expert", "model"))
        self._copies = []
        for ls in self.leaves:
            distinct = 1
            for _, a in storage_splits(ls.spec):
                distinct *= mesh.shape[a] // (ls.kv_rep if a == "model" else 1)
            if fsdp_dim(ls.spec) is not None:
                distinct *= mesh.shape["data"]
            self._copies.append(world // distinct)

    def _expert_split(self, ls) -> bool:
        return any(a == "expert" for _, a in storage_splits(ls.spec))

    def sync(self, grads, leaves) -> List[torch.Tensor]:
        """The gradients summed (or reduce-scattered) over the ranks that
        hold copies.  Under the active mesh without a split batch (rows that
        do not divide), every rank's gradient is the whole batch's, and the
        sums are divided by the (data, expert) size."""
        out = []
        m = self.mesh
        ctx = active()
        n_b = m.size(("data", "expert")) if ctx is not None and not ctx.split_batch else 1
        for g, p, ls in zip(grads, leaves, self.leaves):
            g = torch.zeros_like(p) if g is None else g
            if ls.kv_rep > 1:
                g = comm.all_reduce(g, m.block_groups[ls.kv_rep])
            d = fsdp_dim(ls.spec)
            if d is None:
                g = comm.all_reduce(g, m.group("data" if self._expert_split(ls)
                                               else ("data", "expert")))
            else:
                if not self._expert_split(ls):
                    g = comm.all_reduce(g, m.group("expert"))
                g = comm.reduce_scatter_dim(g, m.group("data"), d)
            out.append(g / n_b if n_b > 1 else g)
        return out

    def norm(self, grads) -> torch.Tensor:
        sq = sum(torch.linalg.vector_norm(g, dtype=torch.float32) ** 2 / c
                 for g, c in zip(grads, self._copies) if g is not None)
        return comm.all_reduce(sq, self.mesh.group(("data", "expert", "model"))).sqrt()

    def _slice(self, p: torch.Tensor, ls) -> torch.Tensor:
        d = fsdp_dim(ls.spec)
        if d is None:
            return p
        return p.chunk(self.mesh.shape["data"], d)[self.mesh.coord["data"]]

    def views(self, params) -> List[Dict[str, torch.Tensor]]:
        """The optimizer's view of params: one {name: slice} per leaf, in
        leaf order (a slice is a view, updated in place)."""
        return [{ls.name: self._slice(t, ls)} for (_, t), ls in
                zip(named_leaves(params), self.leaves)]

    @torch.no_grad()
    def gather(self, params) -> None:
        for (_, t), ls in zip(named_leaves(params), self.leaves):
            d = fsdp_dim(ls.spec)
            if d is not None:
                t.copy_(comm.all_gather_dim(self._slice(t, ls), self.mesh.group("data"), d))


_END = object()


def _fetched(batches: Iterable):
    """The caller's batches, each pull inside a `train.fetch` span."""
    it = iter(batches)
    while True:
        with profiling.span("train.fetch"):
            batch = next(it, _END)
        if batch is _END:
            return
        yield batch


class Trainer:
    """Holds the parameters (on `device`), the optimizer state and the step
    count; `fit` runs the steps, `evaluate` a forward-only pass.

    mesh: train on a (data, expert, model) mesh of ranks.  params is then
    the whole tree, the same on every rank, and the trainer keeps this
    rank's shard (`shard_params`); each batch handed in is the whole batch,
    of which the rank takes its rows; the dynamic experts run
    `dispatch_mode="ep"` when the expert axis has more than one rank;
    `fsdp` (leaves of at least fsdp_min_bytes, `add_fsdp_axis`) keeps the
    optimizer state on each data rank's slice.  Losses, metrics and the
    gradient norm are the whole batch's, as on one device.  Checkpoints are
    per rank (ckpt_dir/rank{r}) when there is more than one."""

    def __init__(self, cfg: UniMoEAudioConfig, params: Dict, tcfg: TrainerConfig, *,
                 logger: Optional[MetricsLogger] = None, device="cuda",
                 mesh: Optional[Mesh] = None, fsdp: bool = False,
                 fsdp_min_bytes: int = 1 << 18):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Trainer runs on a CUDA card and none is available; "
                               "pass device='cpu' to train on the CPU")
        self.ring = None
        if tcfg.ring_axis is not None:
            if mesh is None:
                raise ValueError("ring_axis requires Trainer(mesh=...)")
            if tcfg.ring_axis not in AXES:
                raise ValueError(f"ring_axis {tcfg.ring_axis!r} is not an axis of the mesh "
                                 f"{AXES}")
            self.ring = (mesh, tcfg.ring_axis)
        tp = tcfg.ring_axis != "model"
        for name, t in named_leaves(params):
            if t.device.type != self.device.type:
                raise ValueError(f"parameter {name} is on {t.device}, the trainer on "
                                 f"{self.device}")
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = mesh
        self.plan = None
        self.dispatch_mode = tcfg.dispatch_mode
        self.optimizer = make_optimizer(
            learning_rate=tcfg.learning_rate, weight_decay=tcfg.weight_decay,
            warmup_steps=tcfg.warmup_steps, total_steps=tcfg.total_steps,
            schedule=tcfg.schedule, grad_clip=tcfg.grad_clip,
            trainable_pattern=tcfg.trainable_pattern, grad_accum_steps=tcfg.grad_accum_steps)
        if mesh is not None:
            self.plan = MeshPlan(mesh, params, cfg, fsdp=fsdp, fsdp_min_bytes=fsdp_min_bytes,
                                 model=tp)
            params = shard_params(params, mesh, cfg, model=tp)
            self.optimizer.norm = self.plan.norm
            if mesh.shape["expert"] > 1:
                self.dispatch_mode = "ep"
        self.state = init_train_state(params, self.optimizer,
                                      None if self.plan is None else self.plan.views(params))
        self.logger = logger or MetricsLogger()
        if tcfg.trainable_pattern is not None:
            on = compress_strings_set(
                n.replace("/", ".") for n, _ in named_leaves(params)
                if self.optimizer.trainable(n))
            print(f"[trainer] trainable ({tcfg.trainable_pattern!r}): {sorted(on)}")

    # -- checkpointing (`trainer.py:234-262`) -----------------------------
    def _ckpt_dir(self) -> Optional[str]:
        d = self.tcfg.ckpt_dir
        if d and self.mesh is not None and self.mesh.size(("data", "expert", "model")) > 1:
            d = os.path.join(d, f"rank{self.mesh.rank}")
        return d

    def maybe_resume(self) -> int:
        """Restore the latest checkpoint under ckpt_dir into the trainer's
        state, in place; returns its step (0 when there is none)."""
        ckpt_dir = self._ckpt_dir()
        if not ckpt_dir:
            return 0
        step = latest_step(ckpt_dir)
        if step is None:
            return 0
        restore_checkpoint(ckpt_dir, self.state, step)
        print(f"resumed from checkpoint step {step}")
        return int(step)

    def save(self) -> None:
        """Save the state under ckpt_dir at its step count (pruned to
        max_to_keep steps)."""
        if self._ckpt_dir():
            save_checkpoint(self._ckpt_dir(), self.state.step, self.state,
                            max_to_keep=self.tcfg.max_to_keep)

    def whole_params(self) -> Dict:
        """The whole param tree (gathered from the ranks on a mesh)."""
        if self.mesh is None:
            return self.state.params
        return gather_params(self.state.params, self.mesh, self.cfg, model=self.plan.model)

    def save_pretrained(self, out_dir: str) -> None:
        """Export an inference directory (`model.jax.pkl` + `config.json`)
        that both packages' `UniMoEAudio` load: {"params": the JAX package's
        layer-stacked tree with numpy leaves, "config": cfg.to_dict()}.  bf16
        leaves are written as f32, which holds them exactly (numpy has no
        bf16); both loaders cast to their dtype."""
        import pickle

        params = self.whole_params()
        if not comm.is_writer():
            return
        os.makedirs(out_dir, exist_ok=True)
        blob = {"params": params_to_numpy(params), "config": self.cfg.to_dict()}
        with open(os.path.join(out_dir, "model.jax.pkl"), "wb") as f:
            pickle.dump(blob, f, protocol=4)
        self.cfg.save_json(os.path.join(out_dir, "config.json"))

    # -- vision batches (`trainer.py:264-336`) ----------------------------
    def _prepare_vision_batch(self, batch: Dict) -> Dict:
        """A batch with pixel_values and image_grid_thw made ready for the
        step.  train_vision: the host index arrays of `vision_indices`, the
        merged tokens padded to a multiple of vision_bucket (padding patches
        0), for the tower that runs inside the step.  Otherwise the tower
        runs here, without gradient, and its features replace the image
        tokens' embeddings in `inputs_embeds`.  Both add the mRoPE
        `position_ids` of `get_rope_index`."""
        if "pixel_values" not in batch:
            return batch
        vcfg = self.cfg.vision_config
        if vcfg is None or "vision" not in self.state.params:
            raise ValueError("an image batch needs a model with a vision tower")
        batch = dict(batch)
        pv = batch.pop("pixel_values")
        grid = np.asarray(batch.pop("image_grid_thw"))
        ids = np.asarray(batch["input_ids"])
        if self.tcfg.train_vision:
            pv = np.asarray(pv)
            m2 = vcfg.spatial_merge_size ** 2
            n_merged = pv.shape[0] // m2
            bucket = max(self.tcfg.vision_bucket, 1)
            pad_to = -(-n_merged // bucket) * bucket
            idx = vision_indices(grid, vcfg, pad_merged_to=pad_to)
            if pad_to > n_merged:
                pv = np.concatenate(
                    [pv, np.zeros(((pad_to - n_merged) * m2, pv.shape[1]), pv.dtype)])
            batch["vision_patches"] = pv
            for k in ("pos", "win_ids", "sample_ids", "widx", "reverse"):
                batch[f"vision_{k}"] = idx[k]
            assert int((ids == self.cfg.image_token_id).sum()) == n_merged, (
                "image tokens != merged vision features")
        else:
            params = self.state.params
            with torch.no_grad():
                feats = vision_forward(params["vision"], torch.as_tensor(pv, device=self.device),
                                       grid, vcfg)
                ids_t = torch.as_tensor(ids, device=self.device)
                codec = batch.get("codec_input_ids")
                emb = calculate_input_embedding(
                    params, ids_t, None if codec is None else torch.as_tensor(
                        np.asarray(codec), device=self.device),
                    self.cfg.codec_placeholder_value)
                vmask = ids_t == self.cfg.image_token_id
                n_slots = int(vmask.sum())
                assert n_slots == feats.shape[0], (
                    f"image tokens {n_slots} != features {feats.shape[0]}")
                emb[vmask] = feats.to(emb.dtype)
            batch["inputs_embeds"] = emb
        pos, _ = get_rope_index(ids, self.cfg, image_grid_thw=grid,
                                attention_mask=batch.get("attention_mask"))
        batch["position_ids"] = pos
        return batch

    def _replicated(self, batch: Dict) -> bool:
        """Whether the batch runs whole on every rank: its rows do not divide
        over (data, expert), and the JAX package replicates it
        (`trainer.py:345-360`)."""
        n = 1 if self.mesh is None else self.mesh.size(batch_spec())
        return n > 1 and np.shape(batch["input_ids"])[0] % n != 0

    def _place_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The batch on the device; on a mesh this rank's rows of it, unless
        `_replicated` (the vision tower's inputs whole: every rank runs the
        tower and takes the features of its rows' image tokens, from
        `vision_slot_offset`)."""
        n = 1 if self.mesh is None else self.mesh.size(batch_spec())
        if n == 1 or self._replicated(batch):
            return place_batch(batch, self.device)
        i = self.mesh.index(batch_spec())
        b = np.shape(batch["input_ids"])[0] // n
        out = {}
        for k, v in batch.items():
            bd = 1 if k == "position_ids" else 0
            if k.startswith("vision_"):
                out[k] = v
                continue
            out[k] = v[:, i * b:(i + 1) * b] if bd else v[i * b:(i + 1) * b]
            if k == "input_ids" and "vision_patches" in batch:
                out["vision_slot_offset"] = int(
                    (np.asarray(v[:i * b]) == self.cfg.image_token_id).sum())
        return place_batch(out, self.device)

    def _step_inputs(self, batch: Dict):
        """The placed batch and the mesh context of its step: split_batch
        unless the batch is replicated, tensor parallelism off under a ring
        over the model axis."""
        batch = self._prepare_vision_batch(batch)
        return self._place_batch(batch), use_mesh(
            self.mesh, split_batch=not self._replicated(batch),
            tp=self.tcfg.ring_axis != "model")

    @torch.no_grad()
    def evaluate(self, eval_batches: Iterable[Dict[str, np.ndarray]],
                 max_batches: Optional[int] = None) -> Dict[str, float]:
        """Forward-only pass: mean of the loss metrics over eval_batches,
        with seed 0 for the jitter (the JAX package's fixed key)."""
        sums: Dict[str, float] = {}
        n = 0
        for j, batch in enumerate(eval_batches):
            if max_batches is not None and j >= max_batches:
                break
            batch, on_mesh = self._step_inputs(batch)
            with on_mesh:
                _, m = loss_fn(self.state.params, self.cfg, batch, 0,
                               aux_weight_at_step(self.cfg, self.state.step),
                               dispatch_mode=self.dispatch_mode,
                               capacity=self.tcfg.dispatch_capacity, remat=False,
                               ring=self.ring)
            for k, v in m.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            n += 1
        return {f"eval_{k}": v / max(n, 1) for k, v in sums.items()}

    def fit(self, batches: Iterable[Dict[str, np.ndarray]], max_steps: Optional[int] = None,
            eval_batches: Optional[List[Dict[str, np.ndarray]]] = None) -> List[Dict[str, float]]:
        """Resume from the latest checkpoint (with ckpt_dir), then run one
        step per batch, numbered from the resumed step; stop once the step
        number reaches max_steps.  Every log_every steps log and keep the
        metrics, every save_every steps and at the end save (with ckpt_dir).
        The caller hands in the batches still to run.  Returns the kept
        metrics."""
        start = self.maybe_resume()
        history = []
        t0 = time.time()
        i = 0
        for i, batch in enumerate(_fetched(batches)):
            step_no = start + i
            if max_steps is not None and step_no >= max_steps:
                break
            with profiling.span("train.step"):
                with profiling.span("train.place"):
                    batch, on_mesh = self._step_inputs(batch)
                with on_mesh:
                    self.state, metrics = train_step(
                        self.state, batch, self.tcfg.seed, cfg=self.cfg,
                        optimizer=self.optimizer, dispatch_mode=self.dispatch_mode,
                        capacity=self.tcfg.dispatch_capacity, remat=self.tcfg.remat,
                        ring=self.ring, plan=self.plan)
                if step_no % self.tcfg.log_every == 0:
                    with profiling.span("train.log"):
                        metrics = {k: float(v) for k, v in metrics.items()}
                        if metrics["skipped"]:
                            print(f"[warning] non-finite loss/grad at step {step_no} "
                                  f"(loss={metrics['loss']}) — update skipped")
                        metrics["steps_per_sec"] = (i + 1) / (time.time() - t0)
                        self.logger.log(step_no, metrics)
                        history.append({"step": step_no, **metrics})
            if (self.tcfg.eval_every and eval_batches is not None
                    and step_no > 0 and step_no % self.tcfg.eval_every == 0):
                em = self.evaluate(eval_batches)
                self.logger.log(step_no, em)
                history.append({"step": step_no, **em})
            if self.tcfg.save_every and step_no > 0 and step_no % self.tcfg.save_every == 0:
                self.save()
        if self.tcfg.eval_every and eval_batches is not None:
            em = self.evaluate(eval_batches)
            self.logger.log(start + i, em)
            history.append({"step": start + i, **em})
        self.save()
        return history
