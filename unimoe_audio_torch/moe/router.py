"""DCMoE routing math — counterpart of `unimoe_audio_tpu/moe/router.py`
(Top-P expert count, the closed-form eval mixer with its gradient, the
global routing weight, the load-balancing loss and the static expert
capacity).  Training uses the
eval mixer, as the JAX package does under the default
`ignore_differentiable_router=True`; the Gumbel / straight-through
`sparse_expert_mixer` (`router.py:60-171`) comes with a later slice.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

NEG_INF = -1e30


def dynamic_expert_selection(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Per-token expert count: softmax → sort desc → cumsum → count of
    entries with cumsum < top_p, plus one.  logits [S, E_dyn] → [S] int32."""
    scores = torch.softmax(logits, dim=-1)
    scores_sorted = torch.sort(scores, dim=-1, descending=True).values
    csum = torch.cumsum(scores_sorted, dim=-1)
    return (csum < top_p).to(torch.int32).sum(dim=-1, dtype=torch.int32) + 1


class MixerResult(NamedTuple):
    routing_weights: torch.Tensor  # [S, E_dyn]
    expert_mask: torch.Tensor      # [S, E_dyn] int32


def sparse_expert_mixer_eval(scores: torch.Tensor, top_k: torch.Tensor, *,
                             jitter_eps: float) -> MixerResult:
    """Closed-form eval mixer (`router.py:174-248`): round r selects the
    r-th ranked expert (ties broken by expert index) with multiplier
    exp(v_r) / Σ_{j >= r, near_r(j)} exp(v_j), v the scores sorted desc and
    near_r(j) = not ((v_r - v_j) / max(|v_r|, |v_j|) > 2·jitter_eps)."""
    S, E = scores.shape
    scores = scores.float()
    # rank[s, e] = |{j : v_j > v_e, or v_j == v_e and j < e}| — the stable
    # descending order, by pairwise comparison (E is tiny).
    gt = scores[:, None, :] > scores[:, :, None]
    eq = scores[:, None, :] == scores[:, :, None]
    idx = torch.arange(E, device=scores.device)
    tie = eq & (idx[None, :, None] > idx[None, None, :])
    rank = (gt | tie).to(torch.int32).sum(dim=-1)                # [S, E]
    oh = (rank[:, :, None] == idx[None, None, :]).float()          # [S, e, r]
    v = (oh * scores[:, :, None]).sum(dim=1)                       # [S, r] desc
    oh = oh.transpose(1, 2)                                        # [S, r, e]
    # Gradient as in the JAX package: the permutation, the near-set and the
    # shifts by v_r are constants (stop_gradient there, detach here).
    vs = v.detach()
    factor = torch.maximum(vs.abs()[:, :, None], vs.abs()[:, None, :])
    ratio = (vs[:, :, None] - vs[:, None, :]) / factor             # [S, r, j]
    include = (idx[None, None, :] >= idx[None, :, None]) & ~(ratio > 2 * jitter_eps)
    z = torch.exp(v[:, None, :] - vs[:, :, None])
    denom = torch.where(include, z, torch.zeros_like(z)).sum(dim=-1)   # [S, r]
    mult = torch.exp(v - vs) / denom
    active = idx[None, :] < top_k[:, None]                         # [S, r]
    w = (torch.where(active, mult, torch.zeros_like(mult))[:, :, None] * oh).sum(dim=1)
    m = torch.where(active[:, :, None], oh, torch.zeros_like(oh)).sum(dim=1)
    return MixerResult(routing_weights=w, expert_mask=m.to(torch.int32))


def global_routing_weight(expert_mask: torch.Tensor, full_router_logits: torch.Tensor,
                          num_dynamic: int, routing_weights: torch.Tensor) -> torch.Tensor:
    """Softmax of the full logits over the selected experts; the dynamic
    block is scaled by its group mass."""
    logits = full_router_logits.float()
    masked = torch.where(expert_mask == 0, torch.full_like(logits, NEG_INF), logits)
    gw = torch.softmax(masked, dim=-1)
    dyn, fixed = gw[:, :num_dynamic], gw[:, num_dynamic:]
    dyn_mass = dyn.sum(dim=-1, keepdim=True)
    return torch.cat([routing_weights * dyn_mass, fixed], dim=-1)


def load_balancing_loss(expert_mask: torch.Tensor, full_router_logits: torch.Tensor,
                        num_dynamic: int,
                        aux_balance_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Switch-style load-balancing loss over the dynamic (+ null) experts."""
    logits = full_router_logits.float()
    masked = torch.where(expert_mask == 0,
                         torch.full_like(logits, torch.finfo(torch.float32).min), logits)
    gw = torch.softmax(masked[:, :num_dynamic], dim=-1)
    dyn_mask = expert_mask[:, :num_dynamic].float()
    if aux_balance_weight is None:
        tokens_per_expert = dyn_mask.mean(dim=0)
        prob_per_expert = gw.mean(dim=0)
    else:
        wgt = aux_balance_weight.float()[:, None]
        denom = wgt.sum(dim=0) + 1e-9
        tokens_per_expert = (dyn_mask * wgt).sum(dim=0) / denom
        prob_per_expert = (gw * wgt).sum(dim=0) / denom
    return (tokens_per_expert * prob_per_expert).sum() * num_dynamic


def expert_capacity(num_tokens: int, num_experts: int, capacity_factor: float,
                    min_capacity: int) -> int:
    """Static per-expert capacity, ceil(tokens / experts · factor), at least
    min_capacity (`router.py:299-304`)."""
    return max(math.ceil(num_tokens / num_experts * capacity_factor), min_capacity)
