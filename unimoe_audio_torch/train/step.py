"""Training step of the port: AdamW with the warmup schedule, global-norm
clipping, the no-decay mask and `trainable_pattern` freezing, the loss and
one update — counterpart of `unimoe_audio_tpu/train/step.py`.

The optimizer is written out by hand with optax's semantics, where torch's
own differ: `clip_by_global_norm` scales by max_norm / norm only when
norm >= max_norm (torch's `clip_grad_norm_` adds 1e-6 to the norm);
`warmup_cosine_decay_schedule(0, lr, warmup, total)` gives lr 0 at count
0, so the first update moves no parameter but advances the moments; AdamW
has eps 1e-8 outside the square root, bias correction and decoupled decay;
the moments are kept in the parameter dtype.  A frozen parameter
(`trainable_pattern`) keeps its moments moving and gets a zero update, as
optax's `masked(set_to_zero())` after the chain does.

Unlike optax, the update is applied in place: parameters and moments are
overwritten, with no second copy of either on the card.  The moment
arithmetic runs in f32 and is stored back in the parameter dtype.

Gradient accumulation (`grad_accum_steps` k > 1) is optax's
`MultiSteps(use_grad_mean=True)` around that chain (`step.py:108-110`): one
accumulator per parameter, in the parameter dtype, holds the running mean
acc + (g - acc) / (mini_step + 1) of the micro-step gradients; every k-th
micro-step clips and applies AdamW (and the frozen mask) to the mean,
advances the schedule's count and zeroes the accumulator; the others leave
the parameters as they are.  The step counter counts micro-steps.

Parameter names for the decay mask and `trainable_pattern` are the
slash-joined paths of the JAX package's layer-stacked tree (e.g.
`layers/moe/gate`): the port's per-layer list index is left out, so one
regex selects the same parameters in both.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import UniMoEAudioConfig
from ..models.model import (calculate_input_embedding, fold_seed, model_forward,
                            scatter_vision_features)
from ..models.vision import vision_tower_apply
from ..parallel.comm import all_reduce, group_size
from ..parallel.mesh import batch_group
from .peft import prefix_kv, prepend_virtual_tokens, virtual_embeds


def named_leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) for every leaf, in a fixed order; list indices (the
    per-layer dicts) do not enter the name."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from named_leaves(v, prefix)
    else:
        yield prefix, tree


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1 - min(max(count, 0), steps) / steps) + end


def _cosine(init: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    if decay_steps <= 0:
        raise ValueError("the cosine schedule needs decay_steps > 0")

    def f(count: int) -> float:
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)
    return f


def _join(first: Callable[[int], float], second: Callable[[int], float],
          boundary: int) -> Callable[[int], float]:
    return lambda count: first(count) if count < boundary else second(count - boundary)


def make_lr_schedule(learning_rate: float, warmup_steps: int, total_steps: int,
                     schedule: str = "cosine") -> Callable[[int], float]:
    """Update count -> learning rate: linear warmup from 0, then cosine or
    linear decay (optax's `warmup_cosine_decay_schedule` / joined linear
    schedules, as `make_lr_schedule` in the JAX package); any other
    `schedule` is a constant rate."""
    if schedule == "cosine":
        decay_steps = max(total_steps, warmup_steps + 1)
        return _join(_linear(0.0, learning_rate, warmup_steps),
                     _cosine(learning_rate, decay_steps - warmup_steps), warmup_steps)
    if schedule == "linear":
        return _join(_linear(0.0, learning_rate, warmup_steps),
                     _linear(learning_rate, 0.0, total_steps - warmup_steps), warmup_steps)
    return lambda count: learning_rate


def _decays(name: str) -> bool:
    """Whether a parameter takes weight decay: not norms, not biases (the
    JAX package's decay mask, `step.py:82-86`)."""
    return not any(s in name for s in ("layernorm", "norm", "_b", "/b"))


@dataclass
class OptState:
    mu: List[torch.Tensor]                   # first moments, one per leaf
    nu: List[torch.Tensor]                   # second moments
    count: int = 0                           # updates applied
    acc: Optional[List[torch.Tensor]] = None  # gradient mean of the micro-steps (k > 1)
    mini_step: int = 0                       # micro-steps in acc


def adamw_leaf(p: torch.Tensor, g: Optional[torch.Tensor], m: torch.Tensor, v: torch.Tensor, *,
               scale, lr: float, count: int, b1: float, b2: float, eps: float, wd: float,
               update: bool = True) -> None:
    """One leaf's AdamW update, in place, rounded in the order of the JAX
    package's offload update (`train/offload.py` `_update_fn`): the f32
    moments m and v decay and take the clipped gradient g · scale (None: a
    zero gradient); then, if `update`, p (any dtype) moves by
    -lr · (m̂ / (√v̂ + eps) + wd · p) with the bias corrections of the
    post-increment `count`."""
    m.mul_(b1)
    v.mul_(b2)
    if g is not None:
        g32 = g.float() * scale
        m.add_(g32 * (1 - b1))
        v.add_((g32 * (1 - b2)) * g32)
    if not update:
        return
    u = (m / (1 - b1 ** count)) / ((v / (1 - b2 ** count)).sqrt_() + eps)
    p32 = p.float()
    if wd:
        u = u + wd * p32
    p.copy_(p32 - lr * u)


@dataclass
class AdamW:
    """clip_by_global_norm(grad_clip) → AdamW(schedule) → zero update for
    frozen parameters, as the optax chain of `make_optimizer`."""

    schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    trainable_pattern: Optional[str] = None
    grad_accum_steps: int = 1
    # The global norm of a list of gradients (a trainer on a mesh sets its
    # own, which sums over the ranks' shards).
    norm: Optional[Callable[[List[Optional[torch.Tensor]]], torch.Tensor]] = None
    _pattern: Optional[re.Pattern] = field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.trainable_pattern is not None:
            self._pattern = re.compile(self.trainable_pattern)

    def trainable(self, name: str) -> bool:
        return self._pattern is None or bool(self._pattern.search(name))

    def init(self, params) -> OptState:
        leaves = [t for _, t in named_leaves(params)]
        acc = [torch.zeros_like(t) for t in leaves] if self.grad_accum_steps > 1 else None
        return OptState(mu=[torch.zeros_like(t) for t in leaves],
                        nu=[torch.zeros_like(t) for t in leaves], acc=acc)

    @torch.no_grad()
    def update(self, params, grads: List[Optional[torch.Tensor]], state: OptState,
               grad_norm: torch.Tensor) -> None:
        """One micro-step, in place: with grad_accum_steps 1 the update
        itself; otherwise the gradients join the accumulator's running mean
        and every grad_accum_steps-th call applies the update to the mean
        (optax's MultiSteps, use_grad_mean=True)."""
        k = self.grad_accum_steps
        if k == 1:
            self.apply(params, grads, state, grad_norm)
            return
        n = state.mini_step
        for acc, g in zip(state.acc, grads):
            acc.add_((-acc if g is None else g - acc) / (n + 1))
        if n < k - 1:
            state.mini_step = n + 1
            return
        self.apply(params, list(state.acc), state, (self.norm or global_norm)(state.acc))
        for acc in state.acc:
            acc.zero_()
        state.mini_step = 0

    @torch.no_grad()
    def apply(self, params, grads: List[Optional[torch.Tensor]], state: OptState,
              grad_norm: torch.Tensor) -> None:
        """One update, in place.  grads align with `named_leaves(params)`;
        None stands for a zero gradient (a parameter the loss does not
        reach)."""
        scale = torch.where(grad_norm < self.grad_clip, torch.ones_like(grad_norm),
                            self.grad_clip / grad_norm)
        lr = self.schedule(state.count)
        count = state.count + 1
        for (name, p), g, mu, nu in zip(named_leaves(params), grads, state.mu, state.nu):
            mu32, nu32 = mu.float(), nu.float()
            adamw_leaf(p, g, mu32, nu32, scale=scale, lr=lr, count=count, b1=self.b1,
                       b2=self.b2, eps=self.eps,
                       wd=self.weight_decay if _decays(name) else 0.0,
                       update=self.trainable(name))
            mu.copy_(mu32)
            nu.copy_(nu32)
        state.count = count


def make_optimizer(*, learning_rate: float = 1e-4, weight_decay: float = 0.0,
                   warmup_steps: int = 100, total_steps: int = 10000,
                   schedule: str = "cosine", b1: float = 0.9, b2: float = 0.999,
                   grad_clip: float = 1.0, trainable_pattern: Optional[str] = None,
                   grad_accum_steps: int = 1) -> AdamW:
    """AdamW + warmup-cosine/-linear decay, as `make_optimizer` in the JAX
    package (`step.py:51-111`).  trainable_pattern: regex over parameter
    names; parameters it does not match are frozen.  grad_accum_steps > 1
    applies the update every that many micro-steps, to their mean."""
    if grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {grad_accum_steps}")
    return AdamW(schedule=make_lr_schedule(learning_rate, warmup_steps, total_steps, schedule),
                 b1=b1, b2=b2, weight_decay=weight_decay, grad_clip=grad_clip,
                 trainable_pattern=trainable_pattern, grad_accum_steps=grad_accum_steps)


@dataclass
class TrainState:
    params: Dict
    opt_state: OptState
    step: int                                  # host counter of applied (micro-)steps


def init_train_state(params: Dict, optimizer: AdamW, slices=None) -> TrainState:
    """Marks every floating parameter as requiring a gradient.  slices: the
    optimizer's view of params where it is not params itself (a trainer on
    a mesh, `MeshPlan.views`)."""
    for _, t in named_leaves(params):
        if t.is_floating_point():
            t.requires_grad_(True)
    return TrainState(params=params, step=0,
                      opt_state=optimizer.init(params if slices is None else slices))


def aux_weight_at_step(cfg: UniMoEAudioConfig, step: int) -> float:
    """Linearly decayed aux-loss weight (`step.py:114-121`)."""
    tc = cfg.text_config
    w0, w1 = tc.l_aux_weight, tc.min_l_aux_weight
    steps = max(1, tc.l_aux_weight_decay_steps)
    return w1 if step >= steps else w0 - (w0 - w1) / steps * step


def loss_fn(params: Dict, cfg: UniMoEAudioConfig, batch: Dict[str, torch.Tensor], seed: int,
            aux_weight: float, *, dispatch_mode: str = "dense", capacity: Optional[int] = None,
            remat: bool = True, use_flash: Optional[bool] = None, ring=None,
            seq_axis: Optional[str] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss and its metrics (`step.py:124-208`); `seed` stands
    for the JAX rng key; dispatch_mode and capacity go to the DCMoE blocks.

    A batch with `vision_patches` (and the index arrays of
    `Trainer._prepare_vision_batch`) runs the vision tower inside the
    differentiated step, so the tower trains: the j-th image token of the
    flattened batch takes feats[j] (`step.py:139-161`).  With
    `params["peft"]` the adapters act after that: prompt and P-tuning
    prepend their soft tokens to the embeddings, prefix tuning hands every
    layer its keys and values (`step.py:162-181`).  ring (ring attention's
    group) and seq_axis (sequence parallelism) go to `model_forward`
    (`step.py:134-135, 199-200`)."""
    inputs_embeds = batch.get("inputs_embeds")
    prefix = None
    if "vision_patches" in batch:
        feats = vision_tower_apply(
            params["vision"], batch["vision_patches"], batch["vision_pos"],
            batch["vision_win_ids"], batch["vision_sample_ids"], batch["vision_widx"],
            batch["vision_reverse"], cfg.vision_config)
        emb = calculate_input_embedding(params, batch["input_ids"],
                                        batch.get("codec_input_ids"),
                                        cfg.codec_placeholder_value)
        inputs_embeds = scatter_vision_features(emb, batch["input_ids"], feats,
                                                cfg.image_token_id,
                                                int(batch.get("vision_slot_offset", 0)))
    if "peft" in params:
        peft = params["peft"]
        virt = virtual_embeds(peft)
        if virt is not None:
            if inputs_embeds is None:
                inputs_embeds = calculate_input_embedding(
                    params, batch["input_ids"], batch.get("codec_input_ids"),
                    cfg.codec_placeholder_value)
            batch, inputs_embeds = prepend_virtual_tokens(batch, inputs_embeds, virt)
        prefix = prefix_kv(peft, cfg)
    out = model_forward(
        params, cfg, batch["input_ids"],
        codec_input_ids=batch.get("codec_input_ids"),
        attention_mask=batch.get("attention_mask"),
        position_ids=batch.get("position_ids"),
        inputs_embeds=inputs_embeds,
        codec_labels=batch.get("codec_labels"),
        labels=batch.get("labels"),
        aux_balance_weight=batch.get("aux_balance_weight"),
        aux_loss_weight=aux_weight,
        training=True, seed=seed, remat=remat, use_flash=use_flash,
        dispatch_mode=dispatch_mode, capacity=capacity, prefix_kv=prefix, ring=ring,
        seq_axis=seq_axis)
    zero = torch.zeros((), dtype=torch.float32, device=out.aux_loss.device)
    group = batch_group()
    metrics = {
        "loss": out.loss,
        "codec_loss": out.codec_loss if out.codec_loss is not None else zero,
        "aux_loss": out.aux_loss,
        "mean_top_k": all_reduce(out.router_top_k.float().mean(), group) / group_size(group),
    }
    return out.loss, metrics


def place_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors → tensors on device."""
    return {k: v.to(device) if isinstance(v, torch.Tensor)
            else torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}


def global_norm(grads: List[Optional[torch.Tensor]]) -> torch.Tensor:
    """sqrt(Σ g²) over every gradient, in f32 (optax.global_norm)."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads if g is not None]
    return torch.linalg.vector_norm(torch.stack(norms))


def train_step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int, *,
               cfg: UniMoEAudioConfig, optimizer: AdamW, dispatch_mode: str = "dense",
               capacity: Optional[int] = None, remat: bool = True,
               use_flash: Optional[bool] = None, ring=None, seq_axis: Optional[str] = None,
               plan=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One (micro-)step (`step.py:211-249`): loss and gradients, then the
    optimizer's update in place — unless the loss or the gradient norm is
    not finite, in which case parameters, moments, the accumulator, the
    mini-step and the step count stay as they were (`skipped` = 1).  The
    finite test reads one flag to the host per step.

    plan (`train/trainer.MeshPlan`, on an active split-batch mesh): the
    gradients are summed over the ranks that hold copies of each leaf
    (reduce-scattered to the optimizer's slice under FSDP), the norm is
    taken over the whole model, the optimizer updates its slices and the
    updated slices are all-gathered.  ring and seq_axis go to `loss_fn`
    (`step.py:221-230`)."""
    aux_w = aux_weight_at_step(cfg, state.step)
    loss, metrics = loss_fn(state.params, cfg, batch, fold_seed(seed, state.step), aux_w,
                            dispatch_mode=dispatch_mode, capacity=capacity, remat=remat,
                            use_flash=use_flash, ring=ring, seq_axis=seq_axis)
    leaves = [t for _, t in named_leaves(state.params)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    if plan is not None:
        grads = plan.sync(grads, leaves)
    grad_norm = (plan.norm if plan is not None else global_norm)(grads)
    finite = bool(torch.isfinite(loss.detach()) & torch.isfinite(grad_norm))
    if finite:
        optimizer.update(state.params if plan is None else plan.views(state.params),
                         list(grads), state.opt_state, grad_norm)
        if plan is not None:
            plan.gather(state.params)
        state.step += 1
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = grad_norm
    metrics["skipped"] = torch.tensor(0.0 if finite else 1.0)
    return state, metrics
