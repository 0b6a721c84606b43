"""Pipeline parallelism: GPipe's microbatched stages over a process group —
counterpart of `unimoe_audio_tpu/parallel/pipeline.py`.

Stage s (group rank s of S) owns the layers [s·L/S, (s+1)·L/S).  The batch
is cut into n_micro microbatches, and the schedule runs n_micro + S - 1
ticks: at tick t stage s runs microbatch t - s and hands its activations to
stage s + 1 by `parallel.comm.ppermute`; stage 0 reads fresh microbatches,
the last stage banks its outputs, and the outputs reach every rank.

The backward is GPipe's too, written out: the forward keeps each
microbatch's graph through the stage's layers, and the backward runs the
ticks in reverse, each stage taking its output's gradient from the next
stage (the last from the caller), differentiating its layers and sending
its input's gradient to the stage before.  So each stage's layers get
their own gradients, summed over the microbatches; the gradient of the
embeddings reaches every rank whole, as the outputs do.  (In the JAX
package `jax.grad` transposes the scan and the ppermute; in PyTorch eager
each rank differentiates only its own graph, and a collective in a
per-tensor backward would wait for a rank whose graph never reaches it.)
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..config import TextMoEConfig
from ..models.layers import attention, compute_mrope, rms_norm
from ..moe.block import dcmoe_block
from .comm import all_reduce, group_rank, group_size, ppermute, resolve_group


def stage_layers(layers: List[Dict], group) -> List[Dict]:
    """This rank's stage of the per-layer list: layers [s·L/S, (s+1)·L/S)
    for group rank s of S."""
    group = resolve_group(group)
    S, s = group_size(group), group_rank(group)
    if len(layers) % S:
        raise ValueError(f"layers {len(layers)} must divide into {S} stages")
    n = len(layers) // S
    return layers[s * n:(s + 1) * n]


def _stage_forward(stage: List[Dict], h: torch.Tensor, cos, sin, cfg: TextMoEConfig,
                   kv_valid_mask, dispatch_mode: str) -> torch.Tensor:
    """The stage's layers (`pipeline.py:26-46`): einsum attention, the DCMoE
    block with no padding mask and no training."""
    for lp in stage:
        residual = h
        hn = rms_norm(h, lp["input_layernorm"], cfg.rms_norm_eps)
        attn_out, _ = attention(lp["attn"], hn, cos, sin, cfg, kv_valid_mask=kv_valid_mask,
                                use_flash=False)
        h = residual + attn_out
        residual = h
        hn = rms_norm(h, lp["post_attention_layernorm"], cfg.rms_norm_eps)
        h = residual + dcmoe_block(lp["moe"], hn, cfg, dispatch_mode=dispatch_mode).hidden_states
    return h


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *leaves):
        group, S, stage = run["group"], run["S"], run["stage"]
        n_micro = run["n_micro"]
        grad = any(ctx.needs_input_grad[1:])
        if grad:
            leaves = [t.detach().requires_grad_(t.requires_grad) for t in leaves]
        layers = _rebuild(run["stage_params"], iter(leaves))
        micro_x = x.reshape(n_micro, -1, *x.shape[1:])
        held = torch.zeros_like(micro_x[0])
        outputs, kept = [None] * n_micro, [None] * n_micro
        for t in range(n_micro + S - 1):
            j = t - stage
            if 0 <= j < n_micro:
                x_in = (micro_x[j] if stage == 0 else held).detach()
                with torch.set_grad_enabled(grad):
                    x_in.requires_grad_(grad)
                    y = _stage_forward(layers, x_in, run["cos"][j], run["sin"][j], run["cfg"],
                                       run["mask"][j], run["dispatch_mode"])
                if grad:
                    kept[j] = (x_in, y)
                y = y.detach()
                if stage == S - 1:
                    outputs[j] = y
            else:
                y = held
            # The last stage's output wraps to stage 0, which ignores it.
            held = ppermute(y, group)
        out = torch.cat(outputs) if stage == S - 1 else torch.zeros_like(x)
        ctx.run, ctx.kept, ctx.leaves = run, kept, leaves
        # The last stage's outputs on every rank (JAX's masked psum).
        return all_reduce(out, group)

    @staticmethod
    def backward(ctx, g_out):
        run, kept, leaves = ctx.run, ctx.kept, ctx.leaves
        group, S, stage, n_micro = run["group"], run["S"], run["stage"], run["n_micro"]
        g_micro = g_out.reshape(n_micro, -1, *g_out.shape[1:])
        g_leaves: List[Optional[torch.Tensor]] = [None] * len(leaves)
        g_x = [None] * n_micro
        trainable = [t for t in leaves if t.requires_grad]
        received = torch.zeros_like(g_micro[0])
        for t in reversed(range(n_micro + S - 1)):
            j = t - stage
            if 0 <= j < n_micro:
                x_in, y = kept[j]
                gy = g_micro[j] if stage == S - 1 else received
                gx, *gp = torch.autograd.grad(y, [x_in, *trainable], gy, allow_unused=True)
                it = iter(gp)
                for i, leaf in enumerate(leaves):
                    if leaf.requires_grad:
                        g = next(it)
                        if g is not None:
                            g_leaves[i] = g if g_leaves[i] is None else g_leaves[i] + g
                kept[j] = None
                send = gx
                if stage == 0:
                    g_x[j] = gx
            else:
                send = torch.zeros_like(received)
            received = ppermute(send, group, -1)
        gx_all = torch.cat(g_x) if stage == 0 else torch.zeros_like(g_out)
        return (None, all_reduce(gx_all, group), *g_leaves)


def pipeline_forward(layer_params: List[Dict], final_norm: torch.Tensor,
                     inputs_embeds: torch.Tensor, position_ids: torch.Tensor,
                     cfg: TextMoEConfig, group, *, n_micro: Optional[int] = None,
                     attention_mask: Optional[torch.Tensor] = None,
                     dispatch_mode: str = "dense", staged: bool = False) -> torch.Tensor:
    """The layer stack as S pipeline stages over `group` — a process group
    (None: one stage) or (mesh, axis) — with n_micro microbatches (default
    S), then the final RMSNorm (`pipeline.py:49-137`).

    layer_params: the per-layer list, of which this rank runs its stage
    (`stage_layers`); staged=True: the list holds this rank's stage only,
    so a caller can keep just its own weights.  inputs_embeds [B, T, D] and
    position_ids [3, B, T] (and attention_mask [B, T]) are whole on every
    rank.  Returns the final-norm hidden states [B, T, D] on every rank.

    Refused: B not a multiple of n_micro, L not a multiple of S (the JAX
    package's asserts), and a model with sliding-window layers (the JAX
    stage drops the window)."""
    group = resolve_group(group)
    S, stage = group_size(group), group_rank(group)
    B, T, D = inputs_embeds.shape
    n_micro = n_micro or S
    if B % n_micro:
        raise ValueError(f"batch {B} must divide into {n_micro} microbatches")
    if cfg.has_sliding_layers:
        raise ValueError("pipeline_forward does not window: refused on a model with "
                         "sliding-window layers")
    mine = layer_params if staged else stage_layers(layer_params, group)
    cos, sin = compute_mrope(position_ids, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
    mask = (attention_mask if attention_mask is not None
            else torch.ones(B, T, dtype=torch.int32, device=inputs_embeds.device))
    run = {"group": group, "S": S, "stage": stage, "n_micro": n_micro, "cfg": cfg,
           "stage_params": mine, "dispatch_mode": dispatch_mode,
           "cos": cos.reshape(n_micro, -1, *cos.shape[1:]),
           "sin": sin.reshape(n_micro, -1, *sin.shape[1:]),
           "mask": mask.reshape(n_micro, -1, T)}
    h = _GPipe.apply(run, inputs_embeds, *_leaves(mine))
    return rms_norm(h, final_norm, cfg.rms_norm_eps)
