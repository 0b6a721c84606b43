"""Token sampling for codec-frame decoding — counterpart of
`unimoe_audio_tpu/generate/sampler.py`: temperature → EOS-unless-top →
top-k → top-p → categorical draw, per (batch × channel) row.

Draws come from an explicit torch.Generator by the Gumbel-max trick (what
`jax.random.categorical` does); the numbers differ from JAX's, the
distribution does not.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def topk_threshold_bisect(x: torch.Tensor, k: int, iters: int = 40) -> torch.Tensor:
    """Per-row value `lo` such that `x >= lo` is exactly the top-k set
    (ties at the threshold all stay in).  Same f32 arithmetic as the JAX
    version — `mid = 0.5*lo + 0.5*hi`, `iters` halvings of the
    [finite row min, row max] interval — so the set is bit-identical."""
    lo = torch.where(torch.isfinite(x), x, torch.full_like(x, float("inf"))).amin(-1, keepdim=True)
    hi = x.amax(-1, keepdim=True)
    for _ in range(iters):
        mid = 0.5 * lo + 0.5 * hi
        ge = (x >= mid).to(torch.int32).sum(-1, keepdim=True) >= k
        lo, hi = torch.where(ge, mid, lo), torch.where(ge, hi, mid)
    return lo


def _draw(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row: argmax(logits + Gumbel noise)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device, dtype=torch.float32)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _per_row(x, n: int, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x, np.float32).reshape(-1), device=device)
    return t.expand(n)[:, None] if t.numel() == 1 else t[:, None]


def sample_next_token(
    gen: torch.Generator,
    logits_NxV: torch.Tensor,
    *,
    temperature: Union[float, np.ndarray],
    top_p: Union[float, np.ndarray],
    top_k: Optional[int],
    audio_eos_value: Optional[int],
) -> torch.Tensor:
    """Sample one token per row.  temperature / top_p are host scalars or
    per-row [N] arrays; keeping them on the host lets the top_p >= 1 branch
    be chosen without a device sync."""
    N, V = logits_NxV.shape
    dev = logits_NxV.device
    top_p_host = np.asarray(top_p, np.float32)
    temp = _per_row(temperature, N, dev)
    tp = _per_row(top_p, N, dev)
    logits = logits_NxV.float() / torch.clamp(temp, min=1e-8)
    neg = torch.full((), float("-inf"), device=dev)

    if audio_eos_value is not None and audio_eos_value >= 0:
        # Suppress EOS unless it is already the top logit.
        eos_not_top = logits.argmax(-1) != audio_eos_value
        eos_col = torch.arange(V, device=dev) == audio_eos_value
        logits = torch.where(eos_not_top[:, None] & eos_col[None, :], neg, logits)

    if top_k is not None and top_k < V:
        if bool((top_p_host >= 1.0).all()):
            # The nucleus keeps the whole top-k set: find it sort-free.
            lo = topk_threshold_bisect(logits, top_k)
            return _draw(gen, torch.where(logits >= lo, logits, neg))
        top_vals, top_ids = torch.topk(logits, top_k, dim=-1)      # sorted desc
        csum = torch.cumsum(torch.softmax(top_vals, dim=-1), dim=-1)
        keep = torch.roll(csum <= tp, 1, dims=-1)
        keep[:, 0] = True
        keep = keep | (tp >= 1.0)
        choice = _draw(gen, torch.where(keep, top_vals, neg))
        return torch.gather(top_ids, -1, choice[:, None])[:, 0]

    # No top-k: nucleus over the whole vocabulary.
    probs = torch.softmax(logits, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    csum = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
    sorted_keep = torch.roll(csum <= tp, 1, dims=-1)
    sorted_keep[:, 0] = True
    sorted_keep = sorted_keep | (tp >= 1.0)
    keep = torch.zeros_like(sorted_keep).scatter(-1, order, sorted_keep)
    return _draw(gen, torch.where(keep, logits, neg))
