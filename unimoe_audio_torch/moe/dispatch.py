"""Expert dispatch and compute for DCMoE — counterpart of
`unimoe_audio_tpu/moe/dispatch.py`:

  * dense  — every expert on every token, combined by the routing weight;
  * packed — each expert's selected tokens packed into an [E, cap, D] block
             (one-hot matmuls when the [S, E, cap] one-hot fits
             `_ONEHOT_BUDGET`, a stable argsort pack otherwise), with the
             combine gathering each token's rows back;
  * gmm    — (token, expert) assignments sorted expert-major and run through
             one grouped matrix product per projection, the hand-written
             CUDA kernels of `ops/grouped_gemm.py` on the card.

Weights are plain tensors or `QTensor`s (`ops/quant.py`).  With `a8=True`
and per-channel QTensor weights the dense and packed paths run the expert
products in int8 (`swiglu_expert_ffn`).  `moe_ffn_ep` is the packed path
across the ranks of an expert group (`parallel/mesh.py`): two all-to-alls.

Stacked expert layout as in the JAX package:
  params = {"gate": [E, D, F], "up": [E, D, F], "down": [E, F, D]}
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.grouped_gemm import grouped_matmul
from ..ops.quant import (QTensor, act_quant_int8, dequantize, expert_einsum, is_kmajor, qvalues,
                         wshape)


def _a8_eligible(params: Dict) -> bool:
    """a8 needs per-channel QTensor weights on all three projections
    (`dispatch.py:35-43`)."""
    return all(isinstance(params[k], QTensor) and params[k].s.shape[-2] == 1
               for k in ("gate", "up", "down"))


def int8_expert_matmul(qx: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Exact int32 products qx[e] @ q[e]: qx int8 [E, C, K], w a QTensor
    [E, K, N] → int32 [E, C, N] — the JAX package's
    `einsum(..., preferred_element_type=int32)`.  One `torch._int_mm` per
    expert (it has no batched form).  On CUDA it takes more than 16 rows and
    K, N multiples of 8: the rows are padded with zero rows (q = 0, so the
    padding is exact) to at least 24 and a multiple of 8; a K or N it does
    not take raises there, and so does a weight that is not K-major
    (`ops/quant.kmajor`: a row-major one ran 3-6 x slower on an H100 80GB
    HBM3 at 700 W, or not at all).
    Counts its `_int_mm` calls in `int8_expert_matmul.calls`."""
    wq = qvalues(w)
    if qx.is_cuda and not is_kmajor(wq):
        raise ValueError("int8 expert weights must be K-major on CUDA "
                         "(ops.quant.kmajor_experts); got strides " + str(wq.stride()))
    E, C, _ = qx.shape
    rows = C if C > 16 and C % 8 == 0 else max(24, -(-C // 8) * 8)
    if rows != C:
        qx = F.pad(qx, (0, 0, 0, rows - C))
    out = torch.empty(E, rows, wq.shape[-1], dtype=torch.int32, device=qx.device)
    for e in range(E):
        torch._int_mm(qx[e], wq[e], out=out[e])
    int8_expert_matmul.calls += E
    return out[:, :C]


int8_expert_matmul.calls = 0


def swiglu_expert_ffn(x_ecd: torch.Tensor, params: Dict, *, a8: bool = False) -> torch.Tensor:
    """Batched per-expert SwiGLU FFN: [E, C, D] → [E, C, D].

    a8 with per-channel QTensor weights (`dispatch.py:70-84`): activations
    quantized per row to int8, int8 x int8 → int32 products, the rank-1
    rescale (row scale x channel scale, that product formed first), g and u
    cast to x's dtype before silu(g)·u, h quantized again for the down
    projection.  Any other weights take the plain expression, as in the JAX
    package.  `swiglu_expert_ffn.a8_calls` counts the a8 branch."""
    if a8 and _a8_eligible(params):
        swiglu_expert_ffn.a8_calls += 1
        q, s = act_quant_int8(x_ecd)

        def proj(qx, sx, w):
            return int8_expert_matmul(qx, w).float() * (sx * w.s.float())

        g = proj(q, s, params["gate"]).to(x_ecd.dtype)
        u = proj(q, s, params["up"]).to(x_ecd.dtype)
        hq, hs = act_quant_int8(F.silu(g) * u)
        return proj(hq, hs, params["down"]).to(x_ecd.dtype)
    g = expert_einsum("ecd,edf->ecf", x_ecd, params["gate"])
    u = expert_einsum("ecd,edf->ecf", x_ecd, params["up"])
    return expert_einsum("ecf,efd->ecd", F.silu(g) * u, params["down"])


swiglu_expert_ffn.a8_calls = 0


def moe_ffn_dense(hidden: torch.Tensor, expert_mask: torch.Tensor,
                  router_weight: torch.Tensor, params: Dict, *, a8: bool = False) -> torch.Tensor:
    """Every expert on every token, combined by weight:
    out[s] = Σ_e (w[s, e]·mask[s, e]) · FFN_e(hidden[s])."""
    w = router_weight * expert_mask.to(router_weight.dtype)       # [S, E]
    x = hidden[None].expand(wshape(params["gate"])[0], *hidden.shape)
    y = swiglu_expert_ffn(x, params, a8=a8)                       # [E, S, D]
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
                   router_weight: torch.Tensor, params: Dict,
                   capacity: int, *, a8: bool = False) -> torch.Tensor:
    """Pack → batched expert FFN → weighted combine (`dispatch.py:197-222`).
    One-hot matmuls when S·E·cap fits `_ONEHOT_BUDGET` (decode shapes), the
    argsort pack and gather otherwise; the same slots either way.  Tokens
    past an expert's capacity are dropped from it."""
    S, E = expert_mask.shape
    if S * E * capacity <= _ONEHOT_BUDGET:
        oh, _ = _dispatch_onehot(expert_mask, capacity)
        packed = torch.einsum("sec,sd->ecd", oh.to(hidden.dtype), hidden)
        y = swiglu_expert_ffn(packed, params, a8=a8)               # [E, cap, D]
        w = router_weight * expert_mask.to(router_weight.dtype)
        cw = oh.to(y.dtype) * w[:, :, None].to(y.dtype)
        return torch.einsum("sec,ecd->sd", cw, y)
    packed, _, pos = pack_by_expert(hidden, expert_mask, capacity)
    y = swiglu_expert_ffn(packed.to(hidden.dtype), params, a8=a8)
    return combine_from_packed(y, pos, expert_mask, router_weight)


def _group(axis_name):
    from ..parallel.mesh import active

    ctx = active()
    return None if ctx is None else ctx.mesh.group(axis_name)


def moe_ffn_ep(hidden: torch.Tensor, expert_mask: torch.Tensor, router_weight: torch.Tensor,
               params: Dict, capacity: int, *, axis_name: str = "expert",
               a8: bool = False) -> torch.Tensor:
    """Expert-parallel packed path (`dispatch.py:225-271`), for a batch
    whose tokens are split over the active mesh's `axis_name` group and
    whose dynamic experts are too (each rank holds E_local = E / ep of
    them, `params`): the local tokens packed for all E experts [E, cap, D],
    one all-to-all over the group → [E_local, ep·cap, D] (the rank's
    experts' slots from every rank), the local SwiGLU (a8 included), the
    all-to-all back, the gather-combine into the local tokens.  `capacity`
    must be the group-wide one (`ep_capacity(..., axis_name=...)`).
    Without an active mesh, or with one rank on the axis, it is the packed
    path."""
    from ..parallel.comm import all_to_all, group_size

    group = _group(axis_name)
    ep = group_size(group)
    E_local = wshape(params["gate"])[0]
    packed, _, pos = pack_by_expert(hidden, expert_mask, capacity)      # [E, cap, D]
    D = packed.shape[-1]
    recv = all_to_all(packed.reshape(ep, E_local, capacity, D), group)  # [ep(src), E_l, cap, D]
    x_local = recv.transpose(0, 1).reshape(E_local, ep * capacity, D)
    y_local = swiglu_expert_ffn(x_local.to(hidden.dtype), params, a8=a8)
    y_send = y_local.reshape(E_local, ep, capacity, D).transpose(0, 1)
    y_home = all_to_all(y_send, group).reshape(E_local * ep, capacity, D)
    return combine_from_packed(y_home, pos, expert_mask, router_weight)


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
                params: Dict, *,
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

    QTensor weights (`dispatch.py:330-344`): per-channel, the grouped
    product reads q in x's dtype and each row takes its expert's scales
    after it (through `slot_expert`); group-wise, the weights are
    dequantized first.

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
        p = params[name]
        if isinstance(p, QTensor):
            if p.s.shape[-2] > 1:
                return dequantize(p, hidden.dtype).contiguous()
            return qvalues(p).to(hidden.dtype).contiguous()     # K4 reads row-major weights
        return p.to(hidden.dtype)

    def scale(name, y):
        p = params[name]
        if isinstance(p, QTensor) and p.s.shape[-2] == 1:
            return y * p.s[slot_expert, 0].to(y.dtype)
        return y

    g = scale("gate", grouped_matmul(x_rows, w("gate"), group_sizes))     # [A, F] f32
    u = scale("up", grouped_matmul(x_rows, w("up"), group_sizes))
    h = (F.silu(g) * u).to(hidden.dtype)
    y = scale("down", grouped_matmul(h, w("down"), group_sizes))          # [A, D] f32

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
    """Most tokens routed to any expert (`dispatch.py:415-422`); with
    `axis_name`, the most over the active mesh's group on that axis (an
    all-reduce MAX, the reference's capacity sync)."""
    cap = expert_mask.to(torch.int32).sum(dim=0).max()
    if axis_name is not None:
        from ..parallel.comm import all_reduce

        cap = all_reduce(cap, _group(axis_name), op=torch.distributed.ReduceOp.MAX)
    return cap
