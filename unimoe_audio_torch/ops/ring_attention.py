"""Ring attention — sequence-parallel attention over a process group,
counterpart of `unimoe_audio_tpu/ops/ring_attention.py`.

Group rank r holds the sequence chunk of global positions [r·Tc, (r+1)·Tc)
of q, k and v.  The k/v chunks (and their key validity) travel round the
ring by `parallel.comm.ppermute`, one rank a step, while each rank merges
the chunk attention of its queries against the visiting chunk into an
online-softmax state (acc, m, l); no rank builds a [T, T] score block or
holds the whole sequence's keys.  The causal mask is index arithmetic on
global positions: a ring step knows the source rank of the chunk it sees.

The arithmetic is einsum arithmetic, as in the JAX package (no Pallas
kernel there either), with its roundings: the q·k product in the input
dtype, cast to f32 and scaled by Dh^-0.5; -1e30 for masked scores; p cast
to v's dtype for the product with v.

`ring_step` — one chunk's attention and the merge — is a plain function of
the visiting chunk and its source rank, so one process can compose the p
steps of every rank over a whole sequence (`compose_ring`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.comm import group_rank, group_size, ppermute, resolve_group

NEG_INF = -1e30


def _chunk_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                allowed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalised chunk attention (`ring_attention.py:30-50`).

    q [B, H, Tq, Dh], k/v [B, KV, Tc, Dh], allowed [B, H, Tq, Tc] bool (or
    broadcastable to it).  Returns (acc [B, H, Tq, Dh], m [B, H, Tq],
    l [B, H, Tq]), all f32: acc = Σ exp(s - m)·v over the allowed keys and l
    the matching denominator; a row with no allowed key has l == 0."""
    H, Dh = q.shape[1], q.shape[-1]
    g = H // k.shape[1]
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", q, kk).float() * Dh ** -0.5
    neg = torch.full((), NEG_INF, dtype=s.dtype, device=s.device)
    s = torch.where(allowed, s, neg)
    m = s.amax(dim=-1)
    p = torch.where(allowed, torch.exp(s - m[..., None]), torch.zeros((), device=s.device))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhts,bhsd->bhtd", p.to(vv.dtype), vv).float()
    return acc, m, l


def init_state(q: torch.Tensor):
    """The empty online-softmax state of q's rows: (acc 0, m -1e30, l 0)."""
    B, H, Tc, Dh = q.shape
    return (torch.zeros(B, H, Tc, Dh, dtype=torch.float32, device=q.device),
            torch.full((B, H, Tc), NEG_INF, dtype=torch.float32, device=q.device),
            torch.zeros(B, H, Tc, dtype=torch.float32, device=q.device))


def ring_step(state, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
              rank: int, src: int, *, causal: bool = True):
    """One ring step (`ring_attention.py:82-102`): the queries of chunk
    `rank` attend the visiting chunk of rank `src` (k/v [B, KV, Tc, Dh],
    its key validity [B, Tc]), and the result merges into state by the
    online-softmax recurrence.  Returns the new (acc, m, l)."""
    acc, m, l = state
    Tc = q.shape[2]
    pos = torch.arange(Tc, device=q.device)
    allowed = (valid > 0)[:, None, None, :]
    if causal:
        allowed = allowed & ((src * Tc + pos)[None, :] <= (rank * Tc + pos)[:, None])
    acc2, m2, l2 = _chunk_attn(q, k, v, allowed)
    m_new = torch.maximum(m, m2)
    ea = torch.exp(m - m_new)
    eb = torch.exp(m2 - m_new)
    return acc * ea[..., None] + acc2 * eb[..., None], m_new, l * ea + l2 * eb


def finish(state, dtype: torch.dtype) -> torch.Tensor:
    """acc / l, and 0 in a row with no allowed key, in dtype."""
    acc, _, l = state
    out = torch.where((l > 0)[..., None], acc / l.clamp_min(1e-30)[..., None],
                      torch.zeros((), device=acc.device))
    return out.to(dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_valid: Optional[torch.Tensor] = None, *, group,
                   causal: bool = True) -> torch.Tensor:
    """Sequence-parallel attention over the ring of `group` — a process
    group (None: one rank) or (mesh, axis), the port's counterpart of JAX's
    `axis_name` inside `shard_map`.

    q [B, H, Tc, Dh] and k, v [B, KV, Tc, Dh] are this rank's chunk;
    kv_valid [B, Tc] its key validity (None: all valid).  Returns this
    rank's [B, H, Tc, Dh] of full attention over the concatenated sequence
    (`ring_attention.py:52-113`).  The gradient flows back round the ring,
    so each rank's dk and dv sum the contributions of every rank's
    queries."""
    group = resolve_group(group)
    p, r = group_size(group), group_rank(group)
    B, _, Tc, _ = q.shape
    if kv_valid is None:
        kv_valid = torch.ones(B, Tc, dtype=torch.int32, device=q.device)
    state = init_state(q)
    kv, valid = torch.stack([k, v]), kv_valid
    for s in range(p):
        state = ring_step(state, q, kv[0], kv[1], valid, r, (r - s) % p, causal=causal)
        if s < p - 1:                  # the last rotation would go unused
            kv, valid = ppermute(kv, group), ppermute(valid, group)
    return finish(state, q.dtype)


def compose_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_valid: Optional[torch.Tensor], p: int, *,
                 causal: bool = True) -> torch.Tensor:
    """The whole-sequence output of a ring of p ranks, computed in one
    process: the sequence (q [B, H, T, Dh], k/v [B, KV, T, Dh]) cut into p
    chunks, and each virtual rank's queries taking the ring steps in ring
    order (sources r, r - 1, ...).  Equal to what `ring_attention` returns
    on p ranks, concatenated."""
    B, _, T, _ = q.shape
    if T % p:
        raise ValueError(f"T {T} does not split into {p} chunks")
    Tc = T // p
    if kv_valid is None:
        kv_valid = torch.ones(B, T, dtype=torch.int32, device=q.device)
    outs = []
    for r in range(p):
        state = init_state(q[:, :, r * Tc:(r + 1) * Tc])
        for s in range(p):
            src = (r - s) % p
            cut = slice(src * Tc, (src + 1) * Tc)
            state = ring_step(state, q[:, :, r * Tc:(r + 1) * Tc], k[:, :, cut], v[:, :, cut],
                              kv_valid[:, cut], r, src, causal=causal)
        outs.append(finish(state, q.dtype))
    return torch.cat(outs, dim=2)
