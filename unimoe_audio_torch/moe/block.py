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
dynamic and the fixed experts in int8 (serving only).  The ep dispatch mode
(the parallel slice) raises here.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..config import TextMoEConfig
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
                mixer_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> MoEOutput:
    """Forward of the DCMoE block (`block.py:42-236`).  `seed` (training
    with input jitter or the Gumbel mixer) takes the place of the JAX
    package's rng key: the jitter is drawn from `seed`, the mixer's draws
    from `fold_seed(seed, 1)`, unless `mixer_draws` (gumbel [E_dyn, S,
    E_dyn], coin [E_dyn, S]) gives them;
    aux_balance_weight [B, T] weights tokens in the load-balancing loss.
    dispatch_mode: 'dense' | 'packed' | 'gmm', or 'dense_a8' | 'packed_a8'
    (`block.py:64-80`: int8 expert products, with per-channel QTensor
    weights; serving only); capacity is the packed path's per-expert slot
    count (None = S), assignment_budget the gmm path's total row count
    (None = every slot)."""
    a8 = dispatch_mode.endswith("_a8")
    if a8:
        dispatch_mode = dispatch_mode[:-len("_a8")]
        if training:
            raise ValueError("a8 expert compute is serving-only (round() is not "
                             "differentiable); drop the _a8 suffix for training")
        if dispatch_mode == "gmm":
            raise ValueError("gmm dispatch has no a8 variant (the grouped kernels are bf16)")
    if dispatch_mode == "ep":
        raise NotImplementedError("dispatch_mode='ep' comes with the parallel slice")
    if dispatch_mode not in ("dense", "packed", "gmm"):
        raise ValueError(f"Unknown dispatch_mode: {dispatch_mode}")
    B, T, dim = hidden_states.shape
    S = B * T
    E_dyn = cfg.num_dynamic_experts
    E_real = cfg.mlp_dynamic_expert_num
    E_total = cfg.num_experts
    original = hidden_states

    x = hidden_states
    if training and cfg.fp32_gate:
        x = x.float()
    if training and cfg.input_jitter_noise > 0:
        if seed is None:
            raise ValueError("training DCMoE requires a seed")
        x = x * input_jitter(x.shape, seed, cfg.input_jitter_noise, x.dtype, x.device)
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
        None if aux_balance_weight is None else aux_balance_weight.reshape(S))

    if cfg.token_drop:
        cap = min(R.expert_capacity(S, E_dyn, cfg.capacity_factor, cfg.min_capacity), S)
        dyn = expert_mask[:, :E_dyn]
        if cfg.drop_policy == "probs":
            # Keep each expert's top-`cap` tokens by router logit.
            masked_logits = torch.where(dyn > 0, dynamic_logits,
                                        torch.full_like(dynamic_logits,
                                                        torch.finfo(torch.float32).min))
            keep_idx = torch.topk(masked_logits.t(), cap, dim=-1).indices      # [E_dyn, cap]
            cap_mask = torch.zeros(E_dyn, S, dtype=torch.int32, device=x.device)
            cap_mask.scatter_(1, keep_idx, 1)
            dyn = dyn * cap_mask.t()
        elif cfg.drop_policy == "position":
            locations = torch.cumsum(dyn, dim=0) - 1
            dyn = dyn * (locations < cap).to(dyn.dtype)
        else:
            raise ValueError(f"Invalid drop_policy: {cfg.drop_policy}")
        expert_mask = torch.cat([dyn, expert_mask[:, E_dyn:]], dim=-1)
        routing_weights = torch.where(dyn > 0, routing_weights,
                                      torch.zeros_like(routing_weights))
        routing_weights = routing_weights / (routing_weights.sum(dim=-1, keepdim=True) + 1e-6)

    if E_dyn < E_total:
        global_weight = R.global_routing_weight(
            expert_mask, full_router_logits, E_dyn, routing_weights)
    else:
        global_weight = routing_weights

    x_orig = original.reshape(S, dim)
    gw = global_weight.to(x_orig.dtype)
    real_mask, real_w = expert_mask[:, :E_real], gw[:, :E_real]
    if dispatch_mode == "dense":
        out = D.moe_ffn_dense(x_orig, real_mask, real_w, params["dynamic"], a8=a8)
    elif dispatch_mode == "packed":
        out = D.moe_ffn_packed(x_orig, real_mask, real_w, params["dynamic"],
                               capacity if capacity is not None else S, a8=a8)
    else:
        # The budget counts (token, expert) assignments in all, a different
        # unit from the per-expert `capacity`.
        out = D.moe_ffn_gmm(x_orig, real_mask, real_w, params["dynamic"],
                            assignment_budget=assignment_budget)

    if cfg.mlp_fixed_expert_num > 0:
        x_fixed = x_orig[None].expand(cfg.mlp_fixed_expert_num, *x_orig.shape)
        y_fixed = D.swiglu_expert_ffn(x_fixed, params["fixed"], a8=a8)   # [nF, S, D]
        w_fixed = gw[:, E_dyn:].t()[:, :, None]                    # [nF, S, 1]
        out = out + (y_fixed * w_fixed.to(y_fixed.dtype)).sum(dim=0)

    return MoEOutput(
        hidden_states=out.reshape(B, T, dim).to(hidden_states.dtype),
        router_logits=full_router_logits,
        router_top_k=dynamic_top_k,
        expert_mask=expert_mask,
        router_weight=global_weight,
        aux_loss=aux_loss,
    )


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
