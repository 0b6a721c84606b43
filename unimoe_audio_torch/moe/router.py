"""DCMoE routing math — counterpart of `unimoe_audio_tpu/moe/router.py`
(Top-P expert count, the iterative Gumbel / straight-through mixer, the
closed-form eval mixer with its gradient, the global routing weight, the
load-balancing loss and the static expert capacity).  Training uses the
eval mixer under the default `ignore_differentiable_router=True`, and the
iterative `sparse_expert_mixer` with `training=True` otherwise, as the JAX
package does.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

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


def _mixer_draws(S: int, E: int, max_k: int, seed: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training mixer's random numbers, drawn from a generator seeded
    with `seed` on `device`: Gumbel noise [max_k, S, E] f32 and the
    mask_for_one coins [max_k, S] f32 in [0, 1).  The seed, not a
    generator's running state, fixes them, so a recompute under activation
    checkpointing and a resumed run draw what the first run drew.  (The
    numbers differ from `jax.random.gumbel` / `uniform` for the same seed;
    the distributions do not.)"""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand((max_k, S, E), generator=gen, dtype=torch.float32, device=device)
    gumbel = -torch.log(-torch.log(u.clamp_min_(tiny)))
    coin = torch.rand((max_k, S), generator=gen, dtype=torch.float32, device=device)
    return gumbel, coin


def sparse_expert_mixer(scores: torch.Tensor, top_k: torch.Tensor, *, max_k: int,
                        jitter_eps: float, training: bool = False, seed: Optional[int] = None,
                        draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> MixerResult:
    """The iterative argmax-without-replacement mixer (`router.py:60-171`):
    max_k rounds over every token, round r counting only where
    r < top_k[token].  Each round, on the running scores (the selected
    experts knocked out to -1e30):
      * the threshold mask: experts with (max - score) / max(|score|, |max|)
        > 2·jitter_eps, and the knocked-out ones, leave the round's softmax;
      * the selection: the argmax of the running scores, or in training the
        argmax of the masked running scores plus Gumbel noise;
      * the multiplier: softmax(masked scores) at the selected expert; in
        training scaled by mask_for_one = 1 where the selection is the
        softmax's argmax or the coin > 0.75, else 0.3333, straight through
        (value m·c, gradient dm);
      * the selected expert is knocked out for the later rounds.
    The masks, the selections and the running state carry no gradient (the
    JAX package's stop_gradient); the multiplier's gradient is the masked
    softmax's.  In training the random numbers come from `_mixer_draws(...,
    seed)`, or from `draws` = (gumbel [max_k, S, E], coin [max_k, S]) where
    a caller gives them (the tests feed JAX's draws in)."""
    S, E = scores.shape
    scores = scores.float()
    if training:
        if draws is None:
            if seed is None:
                raise ValueError("the training mixer needs a seed or draws")
            draws = _mixer_draws(S, E, max_k, seed, scores.device)
        gumbel, coin = draws
    sd = scores.detach()
    state = sd.clone()                                      # running scores, knocked out
    neg = torch.full_like(sd, NEG_INF)
    w = torch.zeros_like(scores)
    mask = torch.zeros(S, E, dtype=torch.int32, device=scores.device)
    for r in range(max_k):
        thr = state.max(dim=-1, keepdim=True).values
        factor = torch.maximum(sd.abs(), thr.abs())
        excluded = ((thr - sd) / factor) > (2 * jitter_eps)
        gate_mask = excluded | (state <= NEG_INF)
        probs = torch.softmax(torch.where(gate_mask, neg, scores), dim=-1)
        if training:
            selected = (torch.where(gate_mask, neg, state) + gumbel[r]).argmax(dim=-1)
        else:
            selected = state.argmax(dim=-1)
        mult = probs.gather(-1, selected[:, None])[:, 0]
        if training:
            one = (selected == probs.detach().argmax(dim=-1)) | (coin[r] > 0.75)
            one = 0.3333 + 0.6667 * one.float()
            mult = mult + (mult * one - mult).detach()
        onehot = torch.nn.functional.one_hot(selected, E).bool()
        active = (r < top_k)[:, None]
        w = w + torch.where(active & onehot, mult[:, None], torch.zeros_like(w))
        mask = mask + (active & onehot).to(torch.int32)
        state = torch.where(onehot, neg, state)
    return MixerResult(routing_weights=w, expert_mask=mask)


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
                        aux_balance_weight: Optional[torch.Tensor] = None, *,
                        group=None) -> torch.Tensor:
    """Switch-style load-balancing loss over the dynamic (+ null) experts.
    `group`: the process group the tokens are split over (a split batch);
    the per-expert means are then over every rank's tokens."""
    from ..parallel.comm import group_size, reduce_from

    logits = full_router_logits.float()
    masked = torch.where(expert_mask == 0,
                         torch.full_like(logits, torch.finfo(torch.float32).min), logits)
    gw = torch.softmax(masked[:, :num_dynamic], dim=-1)
    dyn_mask = expert_mask[:, :num_dynamic].float()
    if aux_balance_weight is None:
        if group_size(group) == 1:
            tokens_per_expert = dyn_mask.mean(dim=0)
            prob_per_expert = gw.mean(dim=0)
        else:
            n = dyn_mask.shape[0] * group_size(group)
            tokens_per_expert = reduce_from(dyn_mask.sum(dim=0), group) / n
            prob_per_expert = reduce_from(gw.sum(dim=0), group) / n
    else:
        wgt = aux_balance_weight.float()[:, None]
        denom = reduce_from(wgt.sum(dim=0), group) + 1e-9
        tokens_per_expert = reduce_from((dyn_mask * wgt).sum(dim=0), group) / denom
        prob_per_expert = reduce_from((gw * wgt).sum(dim=0), group) / denom
    return (tokens_per_expert * prob_per_expert).sum() * num_dynamic


def expert_capacity(num_tokens: int, num_experts: int, capacity_factor: float,
                    min_capacity: int) -> int:
    """Static per-expert capacity, ceil(tokens / experts · factor), at least
    min_capacity (`router.py:299-304`)."""
    return max(math.ceil(num_tokens / num_experts * capacity_factor), min_capacity)
