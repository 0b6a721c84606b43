"""The DCMoE block — counterpart of `dcmoe_block`
(`unimoe_audio_tpu/moe/block.py:42-236`) with the dense, packed and gmm
dispatch modes, for inference and training.

  params = {
    "gate":    [D, num_experts]        router projection (no bias)
    "dynamic": {"gate"/"up": [E_real, D, Fd], "down": [E_real, Fd, D]}
    "fixed":   {"gate"/"up": [n_fixed, D, Fs], "down": [n_fixed, Fs, D]}
  }

Null experts exist only in the router.  Fixed experts are always on, and
`padding_token_mask` gates the dynamic selection.  Training adds the f32
router (`fp32_gate`), input jitter on the router's input (experts see the
un-jittered hidden states) and the `aux_balance_weight` emphasis of the
load-balancing loss; the mixer is the closed-form eval mixer under
`ignore_differentiable_router=True` (the default) and the iterative Gumbel /
straight-through mixer otherwise, as in the JAX package.  `token_drop` caps
each expert at `expert_capacity` tokens by router logit or by position.
An `_a8` suffix on the dispatch mode (`dense_a8`, `packed_a8`) runs the
dynamic and the fixed experts in int8 (serving only).

On an active mesh (`parallel/mesh.py`) the experts' intermediate dims are
split over `model` (each rank's FFNs give partial sums, added over the group
at the end) and the dynamic experts over `expert`.  `dispatch_mode="ep"`
(training: tokens split over the expert group) sends each token to its
expert's rank and back (`moe_ffn_ep`); any other mode with expert-split
weights (serving: every rank holds every token) runs the local experts on
all tokens and sums over the expert group.  Under a split batch the
load-balancing statistics, the jitter and mixer draws and the `token_drop`
cut are the whole batch's.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..config import TextMoEConfig
from ..ops.quant import wshape
from ..parallel.comm import all_gather_dim, copy_to, group_size, reduce_from, reduce_scatter
from ..parallel.mesh import active, batch_group, tp_group
from . import dispatch as D
from . import router as R


class MoEOutput(NamedTuple):
    hidden_states: torch.Tensor      # [B, T, D]
    router_logits: torch.Tensor      # [S, num_experts]
    router_top_k: torch.Tensor       # [S]
    expert_mask: torch.Tensor        # [S, num_experts]
    router_weight: torch.Tensor      # [S, num_experts]
    aux_loss: torch.Tensor           # scalar


def input_jitter(shape, seed: int, eps: float, dtype: torch.dtype, device) -> torch.Tensor:
    """Multiplicative router-input noise U(1 - eps, 1 + eps), drawn from a
    generator seeded with `seed` on `device`.  The seed, not a generator's
    running state, fixes the draw, so a recompute under activation
    checkpointing draws the same noise.  (The numbers differ from
    `jax.random.uniform`'s for the same seed.)"""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return (u * (2 * eps) + (1 - eps)).to(dtype)


def dcmoe_block(params: Dict, hidden_states: torch.Tensor, cfg: TextMoEConfig, *,
                padding_token_mask: Optional[torch.Tensor] = None,
                aux_balance_weight: Optional[torch.Tensor] = None,
                training: bool = False,
                seed: Optional[int] = None,
                dispatch_mode: str = "dense",
                capacity: Optional[int] = None,
                assignment_budget: Optional[int] = None,
                mixer_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                seq_parallel: bool = False) -> MoEOutput:
    """Forward of the DCMoE block (`block.py:42-236`).  `seed` (training
    with input jitter or the Gumbel mixer) takes the place of the JAX
    package's rng key: the jitter is drawn from `seed`, the mixer's draws
    from `fold_seed(seed, 1)`, unless `mixer_draws` (gumbel [E_dyn, S,
    E_dyn], coin [E_dyn, S]) gives them;
    aux_balance_weight [B, T] weights tokens in the load-balancing loss.
    dispatch_mode: 'dense' | 'packed' | 'ep' | 'gmm', or 'dense_a8' |
    'packed_a8' | 'ep_a8' (`block.py:64-80`: int8 expert products, with
    per-channel QTensor weights; serving only); capacity is the packed and
    ep paths' per-expert slot count (None = S), assignment_budget the gmm
    path's total row count (None = every slot).  seq_parallel: the output's
    sum over the model group is reduce-scattered over T (Megatron sequence
    parallelism): this rank's [B, T / |model|, D] rows come back."""
    a8 = dispatch_mode.endswith("_a8")
    if a8:
        dispatch_mode = dispatch_mode[:-len("_a8")]
        if training:
            raise ValueError("a8 expert compute is serving-only (round() is not "
                             "differentiable); drop the _a8 suffix for training")
        if dispatch_mode == "gmm":
            raise ValueError("gmm dispatch has no a8 variant (the grouped kernels are bf16)")
    if dispatch_mode not in ("dense", "packed", "gmm", "ep"):
        raise ValueError(f"Unknown dispatch_mode: {dispatch_mode}")
    B, T, dim = hidden_states.shape
    S = B * T
    E_dyn = cfg.num_dynamic_experts
    E_real = cfg.mlp_dynamic_expert_num
    E_total = cfg.num_experts
    original = hidden_states
    ctx = active()
    tp = tp_group()
    bgroup = batch_group()
    n_b = group_size(bgroup)
    i_b = ctx.mesh.index(("data", "expert")) if n_b > 1 else 0

    x = hidden_states
    if training and cfg.fp32_gate:
        x = x.float()
    if training and cfg.input_jitter_noise > 0:
        if seed is None:
            raise ValueError("training DCMoE requires a seed")
        # Under a split batch: the whole batch's draw, this rank's rows.
        noise = input_jitter((B * n_b, T, dim), seed, cfg.input_jitter_noise, x.dtype, x.device)
        x = x * noise[i_b * B:(i_b + 1) * B]
    x = x.reshape(S, dim)

    gate_w = params["gate"]
    if training and cfg.fp32_gate:
        gate_w = gate_w.float()
    # The router weight may be f32 under bf16 activations (as initialised);
    # the product runs in the promoted type, as jnp's `@` does.
    ct = torch.promote_types(x.dtype, gate_w.dtype)
    full_router_logits = x.to(ct) @ gate_w.to(ct)                # [S, E_total]
    dynamic_logits = full_router_logits[:, :E_dyn].float()

    if cfg.mlp_dynamic_top_p != 0:
        dynamic_top_k = R.dynamic_expert_selection(dynamic_logits, cfg.mlp_dynamic_top_p)
    else:
        dynamic_top_k = torch.full((S,), cfg.mlp_dynamic_top_k, dtype=torch.int32,
                                   device=x.device)
    if training and not cfg.ignore_differentiable_router:
        if seed is None and mixer_draws is None:
            raise ValueError("the training mixer requires a seed")
        from ..models.model import fold_seed

        if mixer_draws is None and n_b > 1:
            g, c = R._mixer_draws(S * n_b, E_dyn, E_dyn, fold_seed(seed, 1), x.device)
            mixer_draws = (g[:, i_b * S:(i_b + 1) * S], c[:, i_b * S:(i_b + 1) * S])
        routing_weights, dyn_mask = R.sparse_expert_mixer(
            dynamic_logits, dynamic_top_k, max_k=E_dyn, jitter_eps=cfg.router_jitter_noise,
            training=True, seed=None if seed is None else fold_seed(seed, 1),
            draws=mixer_draws)
    else:
        routing_weights, dyn_mask = R.sparse_expert_mixer_eval(
            dynamic_logits, dynamic_top_k, jitter_eps=cfg.router_jitter_noise)
    routing_weights = routing_weights / (routing_weights.sum(dim=-1, keepdim=True) + 1e-6)

    expert_mask = torch.cat(
        [dyn_mask, torch.zeros(S, E_total - E_dyn, dtype=torch.int32, device=x.device)], dim=-1)
    if padding_token_mask is not None:
        expert_mask = expert_mask * padding_token_mask.reshape(S, 1).to(torch.int32)
    if E_dyn < E_total:
        # Fixed experts are always on.  fill_ with a Python scalar: slice
        # assignment would stage the 1 as a CPU tensor and read it back.
        expert_mask[:, E_dyn:].fill_(1)

    aux_loss = R.load_balancing_loss(
        expert_mask, full_router_logits, E_dyn,
        None if aux_balance_weight is None else aux_balance_weight.reshape(S), group=bgroup)

    if cfg.token_drop:
        expert_mask, routing_weights = _token_drop(cfg, expert_mask, dynamic_logits,
                                                   routing_weights, bgroup, n_b, i_b)
    if E_dyn < E_total:
        global_weight = R.global_routing_weight(
            expert_mask, full_router_logits, E_dyn, routing_weights)
    else:
        global_weight = routing_weights

    # The experts' region: on a model group each rank's FFNs give partial
    # sums, so their inputs (tokens and combine weights) take the group's
    # gradient sum and the output is summed over it at the end.
    x_orig = copy_to(original.reshape(S, dim), tp)
    gw = copy_to(global_weight.to(x_orig.dtype), tp)
    real_mask, real_w = expert_mask[:, :E_real], gw[:, :E_real]
    E_local = wshape(params["dynamic"]["gate"])[0]
    eg = ctx.mesh.group("expert") if ctx is not None else None
    if dispatch_mode != "ep" and E_local < E_real:
        # Every token on every rank of the expert group: the local experts'
        # share of each token, summed over the group.
        if n_b > 1:
            raise ValueError("expert-split weights under a split batch need "
                             "dispatch_mode='ep' (the ranks hold different tokens)")
        e0 = ctx.mesh.coord["expert"] * E_local
        real_mask, real_w = real_mask[:, e0:e0 + E_local], real_w[:, e0:e0 + E_local]
    if dispatch_mode == "dense":
        out = D.moe_ffn_dense(x_orig, real_mask, real_w, params["dynamic"], a8=a8)
    elif dispatch_mode == "packed":
        out = D.moe_ffn_packed(x_orig, real_mask, real_w, params["dynamic"],
                               capacity if capacity is not None else S, a8=a8)
    elif dispatch_mode == "ep":
        out = D.moe_ffn_ep(x_orig, real_mask, real_w, params["dynamic"],
                           capacity if capacity is not None else S, axis_name="expert", a8=a8)
    else:
        # The budget counts (token, expert) assignments in all, a different
        # unit from the per-expert `capacity`.
        out = D.moe_ffn_gmm(x_orig, real_mask, real_w, params["dynamic"],
                            assignment_budget=assignment_budget)
    if dispatch_mode != "ep" and E_local < E_real:
        out = reduce_from(out, eg)
    if not training and cfg.avg_hidden_states_last and dispatch_mode == "ep":
        # Eval-time averaging over the expert group (`block.py:210-213`).
        out = reduce_from(out, eg) / group_size(eg)

    if cfg.mlp_fixed_expert_num > 0:
        x_fixed = x_orig[None].expand(cfg.mlp_fixed_expert_num, *x_orig.shape)
        y_fixed = D.swiglu_expert_ffn(x_fixed, params["fixed"], a8=a8)   # [nF, S, D]
        w_fixed = gw[:, E_dyn:].t()[:, :, None]                    # [nF, S, 1]
        out = out + (y_fixed * w_fixed.to(y_fixed.dtype)).sum(dim=0)
    if seq_parallel:
        out = reduce_scatter(out.reshape(B, T, dim), tp, 1)
    else:
        out = reduce_from(out, tp).reshape(B, T, dim)

    return MoEOutput(
        hidden_states=out.to(hidden_states.dtype),
        router_logits=full_router_logits,
        router_top_k=dynamic_top_k,
        expert_mask=expert_mask,
        router_weight=global_weight,
        aux_loss=aux_loss,
    )


def _token_drop(cfg: TextMoEConfig, expert_mask, dynamic_logits, routing_weights, bgroup,
                n_b: int, i_b: int):
    """Each dynamic expert keeps at most `expert_capacity` tokens of the
    whole batch (`block.py:153-172`): its top tokens by router logit
    ("probs") or its first by position ("position").  Under a split batch
    the ranking keys are gathered over the batch group, the cut is taken
    over the whole batch's tokens as on one device, ties included, and this
    rank keeps its rows.  Returns the cut expert mask and the renormalised
    routing weights."""
    E_dyn = cfg.num_dynamic_experts
    S = expert_mask.shape[0]
    S_all = S * n_b
    cap = min(R.expert_capacity(S_all, E_dyn, cfg.capacity_factor, cfg.min_capacity), S_all)
    dyn = expert_mask[:, :E_dyn]
    dyn_all = all_gather_dim(dyn, bgroup, 0)
    if cfg.drop_policy == "probs":
        # Keep each expert's top-`cap` tokens by router logit.
        masked = torch.where(dyn_all > 0, all_gather_dim(dynamic_logits, bgroup, 0),
                             torch.full((), torch.finfo(torch.float32).min,
                                        device=dyn.device))
        keep_idx = torch.topk(masked.t(), cap, dim=-1).indices          # [E_dyn, cap]
        cap_mask = torch.zeros(E_dyn, S_all, dtype=torch.int32, device=dyn.device)
        cap_mask.scatter_(1, keep_idx, 1)
        keep = cap_mask.t()
    elif cfg.drop_policy == "position":
        keep = (torch.cumsum(dyn_all, dim=0) - 1 < cap).to(dyn.dtype)
    else:
        raise ValueError(f"Invalid drop_policy: {cfg.drop_policy}")
    dyn = dyn * keep[i_b * S:(i_b + 1) * S]
    expert_mask = torch.cat([dyn, expert_mask[:, E_dyn:]], dim=-1)
    routing_weights = torch.where(dyn > 0, routing_weights, torch.zeros_like(routing_weights))
    routing_weights = routing_weights / (routing_weights.sum(dim=-1, keepdim=True) + 1e-6)
    return expert_mask, routing_weights


def init_dcmoe_params(gen: torch.Generator, cfg: TextMoEConfig, *,
                      dtype=torch.bfloat16, device="cuda") -> Dict:
    """Random DCMoE weights made on `device`: the router in f32 (normal,
    std = initializer_range), experts in `dtype` (scaled normal)."""
    dim = cfg.hidden_size
    Fd, Fs = cfg.dynamic_intermediate_size, cfg.shared_intermediate_size
    Er, Nf = cfg.mlp_dynamic_expert_num, cfg.mlp_fixed_expert_num

    def nrm(shape, scale, dt=dtype):
        return torch.randn(*shape, generator=gen, dtype=dt, device=device).mul_(scale)

    return {
        "gate": nrm((dim, cfg.num_experts), cfg.initializer_range, torch.float32),
        "dynamic": {
            "gate": nrm((Er, dim, Fd), dim ** -0.5),
            "up": nrm((Er, dim, Fd), dim ** -0.5),
            "down": nrm((Er, Fd, dim), Fd ** -0.5),
        },
        "fixed": {
            "gate": nrm((Nf, dim, Fs), dim ** -0.5),
            "up": nrm((Nf, dim, Fs), dim ** -0.5),
            "down": nrm((Nf, Fs, dim), Fs ** -0.5),
        },
    }
