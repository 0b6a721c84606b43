"""Expert dispatch and compute for DCMoE — counterpart of
`unimoe_audio_tpu/moe/dispatch.py` (plain-weight branches):

  * dense  — every expert on every token, combined by the routing weight;
  * packed — each expert's selected tokens packed into an [E, cap, D] block
             (one-hot matmuls when the [S, E, cap] one-hot fits
             `_ONEHOT_BUDGET`, a stable argsort pack otherwise), with the
             combine gathering each token's rows back;
  * gmm    — (token, expert) assignments sorted expert-major and run through
             one grouped matrix product per projection, the hand-written
             CUDA kernels of `ops/grouped_gemm.py` on the card.

Expert parallelism (`moe_ffn_ep`) comes with the parallel slice, a8 and
quantized weights with the quantization slice; both raise here.

Stacked expert layout as in the JAX package:
  params = {"gate": [E, D, F], "up": [E, D, F], "down": [E, F, D]}
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.grouped_gemm import grouped_matmul
from ..ops.quant import _plain, expert_einsum, wshape


def swiglu_expert_ffn(x_ecd: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Batched per-expert SwiGLU FFN: [E, C, D] → [E, C, D]."""
    g = expert_einsum("ecd,edf->ecf", x_ecd, params["gate"])
    u = expert_einsum("ecd,edf->ecf", x_ecd, params["up"])
    return expert_einsum("ecf,efd->ecd", F.silu(g) * u, params["down"])


def moe_ffn_dense(hidden: torch.Tensor, expert_mask: torch.Tensor,
                  router_weight: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Every expert on every token, combined by weight:
    out[s] = Σ_e (w[s, e]·mask[s, e]) · FFN_e(hidden[s])."""
    w = router_weight * expert_mask.to(router_weight.dtype)       # [S, E]
    x = hidden[None].expand(wshape(params["gate"])[0], *hidden.shape)
    y = swiglu_expert_ffn(x, params)                              # [E, S, D]
    return (y * w.t()[:, :, None].to(y.dtype)).sum(dim=0)


def pack_by_expert(hidden: torch.Tensor, expert_mask: torch.Tensor, capacity: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each expert's selected tokens in sequence order, packed into a dense
    [E, cap, D] block (`dispatch.py:131-151`).  Returns (packed, token_idx
    [E, cap], pos [S, E]) with pos[s, e] the slot of token s in expert e's
    block (meaningful where selected).  capacity <= S."""
    mask = expert_mask.to(torch.int32)
    pos = torch.cumsum(mask, dim=0) - 1
    order = torch.argsort(1 - mask, dim=0, stable=True)          # selected tokens first
    token_idx = order[:capacity].t()
    packed = hidden[token_idx]
    counts = mask.sum(dim=0)
    slot_valid = torch.arange(capacity, device=hidden.device)[None, :] < counts[:, None]
    packed = torch.where(slot_valid[..., None], packed, torch.zeros_like(packed))
    return packed, token_idx, pos


def combine_from_packed(y_packed: torch.Tensor, pos: torch.Tensor, expert_mask: torch.Tensor,
                        router_weight: torch.Tensor) -> torch.Tensor:
    """Weighted gather-combine of packed expert outputs back to [S, D]
    (`dispatch.py:154-173`); a token past an expert's capacity gets nothing
    from it."""
    E, capacity = y_packed.shape[:2]
    w = (router_weight * expert_mask.to(router_weight.dtype)).to(y_packed.dtype)
    safe_pos = pos.clamp(0, capacity - 1)
    y_tok = y_packed[torch.arange(E, device=pos.device)[None, :], safe_pos]   # [S, E, D]
    in_cap = (pos < capacity) & (expert_mask > 0)
    w = torch.where(in_cap, w, torch.zeros_like(w))
    return torch.einsum("se,sed->sd", w, y_tok)


# One-hot dispatch tensors stay under this many elements before the packed
# path falls back to the argsort pack (the [S, E, cap] one-hot is S·E·cap).
_ONEHOT_BUDGET = 4 << 20


def _dispatch_onehot(expert_mask: torch.Tensor, capacity: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """oh[s, e, c] = token s is expert e's c-th selected token, and pos
    [S, E] (`dispatch.py:181-194`): the slots of `pack_by_expert`'s stable
    argsort, from a cumsum and a compare."""
    mask = expert_mask.to(torch.int32)
    pos = torch.cumsum(mask, dim=0) - 1
    slot = torch.arange(capacity, dtype=torch.int32, device=mask.device)
    oh = (pos[:, :, None] == slot[None, None, :]) & (mask[:, :, None] > 0)
    return oh, pos


def moe_ffn_packed(hidden: torch.Tensor, expert_mask: torch.Tensor,
                   router_weight: torch.Tensor, params: Dict[str, torch.Tensor],
                   capacity: int) -> torch.Tensor:
    """Pack → batched expert FFN → weighted combine (`dispatch.py:197-222`).
    One-hot matmuls when S·E·cap fits `_ONEHOT_BUDGET` (decode shapes), the
    argsort pack and gather otherwise; the same slots either way.  Tokens
    past an expert's capacity are dropped from it."""
    S, E = expert_mask.shape
    if S * E * capacity <= _ONEHOT_BUDGET:
        oh, _ = _dispatch_onehot(expert_mask, capacity)
        packed = torch.einsum("sec,sd->ecd", oh.to(hidden.dtype), hidden)
        y = swiglu_expert_ffn(packed, params)                      # [E, cap, D]
        w = router_weight * expert_mask.to(router_weight.dtype)
        cw = oh.to(y.dtype) * w[:, :, None].to(y.dtype)
        return torch.einsum("sec,ecd->sd", cw, y)
    packed, _, pos = pack_by_expert(hidden, expert_mask, capacity)
    y = swiglu_expert_ffn(packed.to(hidden.dtype), params)
    return combine_from_packed(y, pos, expert_mask, router_weight)


def moe_ffn_ep(*args, **kwargs):
    raise NotImplementedError("expert-parallel dispatch (moe_ffn_ep) comes with the parallel "
                              "slice")


def gmm_group_sizes(expert_mask: torch.Tensor, rows: int) -> torch.Tensor:
    """Rows per expert of `moe_ffn_gmm`'s assignment matrix, int32 [E]: each
    expert's selected count, cut where the running total passes `rows`, and
    every remaining row (unselected slots, padding) in the last group."""
    counts = expert_mask.to(torch.int32).sum(dim=0, dtype=torch.int32)
    kept = torch.cumsum(counts, dim=0, dtype=torch.int32).clamp(max=rows)
    kept_counts = torch.diff(kept, prepend=kept.new_zeros(1))
    pad = rows - kept_counts.sum(dtype=torch.int32)
    return torch.cat([kept_counts[:-1], kept_counts[-1:] + pad]).to(torch.int32)


def moe_ffn_gmm(hidden: torch.Tensor, expert_mask: torch.Tensor, router_weight: torch.Tensor,
                params: Dict[str, torch.Tensor], *,
                assignment_budget: Optional[int] = None) -> torch.Tensor:
    """Grouped-GEMM path (`dispatch.py:274-371`): the (token, expert) slots
    flattened expert-major and stably sorted selected-first, so each
    expert's tokens form one group of rows in sequence order; one grouped
    product per projection over those rows.

    assignment_budget: the row count A.  None gives ceil(S·E / 128)·128, so
    every slot, selected or not, has a row and nothing is dropped; a budget
    below the selected count drops the highest experts' last assignments.
    Rows of unselected slots and padding are zero and belong to the last
    group, so every row is computed (zero in, zero out).

    On the card the whole path stays there: group sizes are computed and
    read on the device, never on the host.  The combine is a sum over the
    experts in a fixed order: without a budget every slot has exactly one
    row, and an inverse permutation takes each slot back to its row (a slot
    without a row reads a zero row), so the sum equals the JAX package's
    scatter-add up to f32 summation order, without atomics."""
    S, Dm = hidden.shape
    E = expert_mask.shape[1]
    dev = hidden.device
    n_slots = S * E
    A = assignment_budget or -(-n_slots // 128) * 128

    mask_es = expert_mask.t().reshape(-1).to(torch.int32)          # [E·S] expert-major
    order = torch.argsort(1 - mask_es, stable=True)                # selected first
    slots = order[:A]
    if A > n_slots:
        slots = torch.cat([slots, torch.zeros(A - n_slots, dtype=slots.dtype, device=dev)])
    slot_expert = slots // S
    slot_token = slots % S
    slot_valid = (torch.arange(A, device=dev) < n_slots) & (mask_es[slots] > 0)

    x_rows = hidden[slot_token]
    x_rows = torch.where(slot_valid[:, None], x_rows, torch.zeros_like(x_rows))   # [A, D]
    group_sizes = gmm_group_sizes(expert_mask, A)

    def w(name):
        return _plain(params[name]).to(hidden.dtype)

    g = grouped_matmul(x_rows, w("gate"), group_sizes)             # [A, F] f32
    u = grouped_matmul(x_rows, w("up"), group_sizes)
    h = (F.silu(g) * u).to(hidden.dtype)
    y = grouped_matmul(h, w("down"), group_sizes)                  # [A, D] f32

    w_rows = router_weight[slot_token, slot_expert] * \
        expert_mask[slot_token, slot_expert].to(router_weight.dtype)
    w_rows = torch.where(slot_valid, w_rows, torch.zeros_like(w_rows))
    contrib = torch.cat([y * w_rows[:, None].float(), y.new_zeros(1, Dm)])   # row A = 0
    row_of_slot = torch.empty_like(order)
    row_of_slot[order] = torch.arange(n_slots, device=dev)
    row_of_slot = row_of_slot.clamp(max=A)                         # dropped slots → zero row
    out = contrib[row_of_slot].reshape(E, S, Dm).sum(dim=0)
    return out.to(hidden.dtype)


def compress_matrix(A: torch.Tensor, mask: torch.Tensor, force_dim: int) -> torch.Tensor:
    """[S, E, ...] → [force_dim, E, ...]: each column's selected rows packed
    to the top in sequence order, zeros below (`dispatch.py:374-393`)."""
    S, E = mask.shape
    trail = (1,) * (A.dim() - 2)
    order = torch.argsort(1 - mask.to(torch.int32), dim=0, stable=True)    # [S, E]
    idx = order[:force_dim]
    gathered = torch.take_along_dim(A, idx.reshape(idx.shape + trail), dim=0)
    if force_dim > S:
        pad = torch.zeros((force_dim - S,) + A.shape[1:], dtype=A.dtype, device=A.device)
        gathered = torch.cat([gathered, pad], dim=0)
    counts = mask.to(torch.int32).sum(dim=0)
    valid = torch.arange(force_dim, device=A.device)[:, None] < counts[None, :]
    return gathered * valid.reshape((force_dim, E) + trail).to(A.dtype)


def decompress_matrix(B_mat: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Inverse scatter of `compress_matrix` (`dispatch.py:396-412`): row c of
    column e goes back to the c-th selected position; unselected positions
    are zero."""
    S, E = mask.shape
    X = min(B_mat.shape[0], S)
    trail = (1,) * (B_mat.dim() - 2)
    order = torch.argsort(1 - mask.to(torch.int32), dim=0, stable=True)[:X]
    out = torch.zeros((S, E) + B_mat.shape[2:], dtype=B_mat.dtype, device=B_mat.device)
    e_idx = torch.arange(E, device=mask.device)[None, :].expand(X, E)
    counts = mask.to(torch.int32).sum(dim=0)
    valid = (torch.arange(X, device=mask.device)[:, None] < counts[None, :]).reshape(
        (X, E) + trail)
    out[order, e_idx] = B_mat[:X] * valid.to(B_mat.dtype)
    return out


def ep_capacity(expert_mask: torch.Tensor, *, axis_name: Optional[str] = None) -> torch.Tensor:
    """Most tokens routed to any expert (`dispatch.py:415-422`); the
    cross-rank max over `axis_name` comes with the parallel slice."""
    if axis_name is not None:
        raise NotImplementedError("ep_capacity across ranks (axis_name) comes with the parallel "
                                  "slice")
    return expert_mask.to(torch.int32).sum(dim=0).max()
