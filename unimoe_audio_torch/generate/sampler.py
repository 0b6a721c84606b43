"""Token sampling for codec-frame decoding — counterpart of
`unimoe_audio_tpu/generate/sampler.py`: temperature → EOS-unless-top →
top-k → top-p → categorical draw, per (batch × channel) row.

Draws come from an explicit torch.Generator by the Gumbel-max trick (what
`jax.random.categorical` does); the numbers differ from JAX's, the
distribution does not.  With per-row keys (`row_keys`, the loop's
per-request `sample_seeds`) the uniforms are counter-based instead: an
integer hash of (seed, step, channel, vocabulary column), so that a row's
draw does not depend on which other rows share the batch — the port's
counterpart of JAX's `fold_in(PRNGKey(seed), step, channel)` chains.  The
hash is integer-only, so the card and the CPU draw the same uniforms.
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


_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for int64 x in [0, 2**32): the constant is split in
    16-bit halves, so that no product leaves the int64 range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xor-shift-multiply, constants of the
    "lowbias32" hash) on int64 tensors holding 32-bit values."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def row_keys(seeds: torch.Tensor, steps: torch.Tensor, channels: int) -> torch.Tensor:
    """Per-(sample, channel) keys [B·C] int64 from per-sample seeds and
    fold steps [B]: mix(mix(mix(seed) ^ step) ^ channel), row b·C + c."""
    k = mix32(mix32(seeds.to(torch.int64)) ^ (steps.to(torch.int64) & _M32))   # [B]
    ch = torch.arange(channels, dtype=torch.int64, device=k.device)
    return mix32(k[:, None] ^ ch[None, :]).reshape(-1)


def counter_uniform(keys: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Uniforms in (0, 1), f32, one per (row key [N], column [N, V] or [V]):
    the top 24 bits of mix(key ^ mix(column)), offset by half a step."""
    h = mix32(keys[:, None] ^ mix32(cols.to(torch.int64)))
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


def _draw(gen: Optional[torch.Generator], logits: torch.Tensor, keys=None,
          cols=None) -> torch.Tensor:
    """One categorical draw per row: argmax(logits + Gumbel noise).  The
    uniforms come from `gen`, or with `keys` [N] from `counter_uniform` at
    the vocabulary columns `cols` (default 0 … V-1)."""
    if keys is None:
        u = torch.rand(logits.shape, generator=gen, device=logits.device, dtype=torch.float32)
    else:
        if cols is None:
            cols = torch.arange(logits.shape[-1], device=logits.device)
        u = counter_uniform(keys, cols)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _per_row(x, n: int, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        t = x.reshape(-1)
    else:
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
    keys: Optional[torch.Tensor] = None,
    full_top_k: Optional[bool] = None,
) -> torch.Tensor:
    """Sample one token per row.  temperature / top_p are host scalars,
    per-row [N] arrays or f32 device tensors [N].  full_top_k: whether
    every row's top_p >= 1, so that the nucleus keeps the whole top-k set;
    a host decision, so that the branch is chosen without a device sync.
    None reads it from top_p, which must then be host values.  keys [N]
    (`row_keys`): counter-based draws per row in place of `gen`'s stream;
    the nucleus path keys each candidate by its vocabulary id."""
    N, V = logits_NxV.shape
    dev = logits_NxV.device
    if full_top_k is None:
        full_top_k = bool((np.asarray(top_p, np.float32) >= 1.0).all())
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
        if full_top_k:
            # The nucleus keeps the whole top-k set: find it sort-free.
            lo = topk_threshold_bisect(logits, top_k)
            return _draw(gen, torch.where(logits >= lo, logits, neg), keys)
        top_vals, top_ids = torch.topk(logits, top_k, dim=-1)      # sorted desc
        csum = torch.cumsum(torch.softmax(top_vals, dim=-1), dim=-1)
        keep = torch.roll(csum <= tp, 1, dims=-1)
        keep[:, 0] = True
        keep = keep | (tp >= 1.0)
        choice = _draw(gen, torch.where(keep, top_vals, neg), keys, top_ids)
        return torch.gather(top_ids, -1, choice[:, None])[:, 0]

    # No top-k: nucleus over the whole vocabulary.
    probs = torch.softmax(logits, dim=-1)
    order = torch.argsort(-probs, dim=-1, stable=True)
    csum = torch.cumsum(torch.gather(probs, -1, order), dim=-1)
    sorted_keep = torch.roll(csum <= tp, 1, dims=-1)
    sorted_keep[:, 0] = True
    sorted_keep = sorted_keep | (tp >= 1.0)
    keep = torch.zeros_like(sorted_keep).scatter(-1, order, sorted_keep)
    return _draw(gen, torch.where(keep, logits, neg), keys)
