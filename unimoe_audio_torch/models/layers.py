"""Transformer building blocks of the port: RMSNorm, mRoPE, GQA attention
over a preallocated, time-major KV cache.

Counterpart of `unimoe_audio_tpu/models/layers.py`.  Parameters are plain
dicts of tensors in the JAX package's layout ([D, F] projection weights).
The cache is written in place (the JAX version rebuilds it functionally),
which keeps one copy of it in device memory.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import TextMoEConfig
from ..ops.quant import proj_matmul

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Qwen2RMSNorm: normalize in fp32, scale, cast back."""
    dtype = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def compute_mrope(position_ids: torch.Tensor, head_dim: int, rope_theta: float,
                  mrope_section: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multimodal rotary embedding: frequency f takes its angle from the
    (t, h, w) position row of its mrope section.  position_ids [3, B, T] →
    cos, sin [B, T, head_dim] f32."""
    half = head_dim // 2
    dev = position_ids.device
    inv_freq = 1.0 / (rope_theta ** (torch.arange(0, half, dtype=torch.float32, device=dev) / half))
    angles = position_ids[..., None].float() * inv_freq            # [3, B, T, half]
    freq = torch.arange(half, device=dev)
    # Section bounds stay host ints: no host-to-device copy per call.
    bounds = np.cumsum(mrope_section).tolist()
    row = sum((freq >= b).long() for b in bounds)                  # [half] in {0, 1, 2}
    picked = torch.gather(angles, 0, row.view(1, 1, 1, half).expand(1, *angles.shape[1:]))[0]
    emb = torch.cat([picked, picked], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin):
    """q, k: [B, T, H, Dh]; cos, sin: [B, T, Dh]."""
    cos = cos[:, :, None, :].to(q.dtype)
    sin = sin[:, :, None, :].to(q.dtype)
    return q * cos + rotate_half(q) * sin, k * cos + rotate_half(k) * sin


class KVCache:
    """Preallocated bf16 KV cache, time-major [L, T_max, B, KV, Dh], as in
    the JAX package: the decode window [0, w) is a contiguous leading
    slice of each layer.  Written in place.  (The int8 cache comes with the
    quantization slice.)"""

    def __init__(self, k: torch.Tensor, v: torch.Tensor):
        self.k = k
        self.v = v

    @classmethod
    def create(cls, num_layers, batch, max_len, kv_heads, head_dim, *,
               dtype=torch.bfloat16, device="cuda"):
        shape = (num_layers, max_len, batch, kv_heads, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    def grow(self, max_len: int) -> "KVCache":
        """A cache of max_len slots holding this one's contents."""
        L, T, B, KV, Dh = self.k.shape
        out = KVCache.create(L, B, max_len, KV, Dh, dtype=self.k.dtype, device=self.k.device)
        out.k[:, :T] = self.k
        out.v[:, :T] = self.v
        return out


def update_cache_slice(cache_k, cache_v, k_new, v_new, start: int):
    """Write [B, T_new, KV, Dh] into per-layer [T_max, B, KV, Dh] slices at
    time offset `start`, in place."""
    T_new = k_new.shape[1]
    cache_k[start:start + T_new] = k_new.transpose(0, 1).to(cache_k.dtype)
    cache_v[start:start + T_new] = v_new.transpose(0, 1).to(cache_v.dtype)
    return cache_k, cache_v


def attention(
    params: Dict,
    x: torch.Tensor,                 # [B, T, D]
    cos: torch.Tensor,
    sin: torch.Tensor,
    cfg: TextMoEConfig,
    *,
    cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # per-layer [T_max, B, KV, Dh]
    cache_position: Optional[int] = None,
    kv_valid_mask: Optional[torch.Tensor] = None,                  # [B, T_kv] 1 = attendable
    causal: bool = True,
    use_flash: Optional[bool] = None,
    decode_emit: bool = False,
    cache_scales=None,
    prefix_kv=None,
    ring=None,
):
    """GQA attention (q/k/v with bias, o without — Qwen2.5 layout), as
    `unimoe_audio_tpu/models/layers.py:150-391`.  Modes:

      * no cache: self-attention over x with causal + padding mask;
      * cache: writes k/v at cache_position (in place) and attends over the
        whole cache masked by kv_valid_mask; with use_flash (a
        cache_position == 0 prefill) the fresh window goes through the
        flash kernel instead;
      * decode_emit (T == 1): attends over the stale cache (the mask must
        exclude the current slot) plus an explicit self-term, and returns
        the fresh (k, v) for the caller to commit.

    Returns (out [B, T, D], cache (k, v) / fresh (k, v) / None).
    """
    if cache_scales is not None:
        raise NotImplementedError("the int8 KV cache comes with the quantization slice")
    if prefix_kv is not None:
        raise NotImplementedError("prefix-tuning KV comes with the PEFT slice")
    if ring is not None:
        raise NotImplementedError("ring attention comes with the parallel slice")

    B, T, _ = x.shape
    H, KV, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    groups = H // KV
    scale = Dh ** -0.5

    q = (proj_matmul(x, params["q_proj"]) + params["q_proj"]["b"]).reshape(B, T, H, Dh)
    k = (proj_matmul(x, params["k_proj"]) + params["k_proj"]["b"]).reshape(B, T, KV, Dh)
    v = (proj_matmul(x, params["v_proj"]) + params["v_proj"]["b"]).reshape(B, T, KV, Dh)
    q, k = apply_rope(q, k, cos, sin)

    if decode_emit:
        assert T == 1 and cache_kv is not None and kv_valid_mask is not None
        k_all, v_all = cache_kv                               # [T_kv, B, KV, Dh]
        qg = q.reshape(B, KV, groups, Dh)
        self_score = torch.einsum(
            "bkgd,bkd->bkg", qg, k.reshape(B, KV, Dh).to(qg.dtype)).float() * scale
        s = torch.einsum("sbkd,bkgd->sbkg", k_all.to(qg.dtype), qg).float() * scale
        valid = kv_valid_mask > 0                             # [B, T_kv]
        s = torch.where(valid.t()[:, :, None, None], s, torch.full_like(s, NEG_INF))
        all_s = torch.cat([s, self_score[None]], dim=0)
        probs = torch.softmax(all_s, dim=0).to(x.dtype)
        T_kv = k_all.shape[0]
        o = torch.einsum("sbkg,sbkd->bkgd", probs[:T_kv], v_all.to(x.dtype))
        o = o + probs[T_kv][..., None] * v.reshape(B, KV, 1, Dh).to(x.dtype)
        out = proj_matmul(o.reshape(B, 1, H * Dh), params["o_proj"])
        return out, (k, v)

    if cache_kv is not None:
        k_all, v_all = update_cache_slice(cache_kv[0], cache_kv[1], k, v, cache_position)
        cache_kv = (k_all, v_all)
    else:
        k_all, v_all = k, v

    if use_flash is None:
        # Auto mode never takes flash in cache mode: the window covers only
        # the fresh k/v, which is right solely for a cache_position == 0
        # prefill; the generate loop's prefill opts in with use_flash=True.
        use_flash = T >= 128 and causal and cache_kv is None and x.is_cuda
    if use_flash and T > 1 and causal:
        from ..ops.flash_attention import flash_attention

        window_valid = (
            kv_valid_mask[:, :T].to(torch.int32).contiguous() if kv_valid_mask is not None
            else torch.ones(B, T, dtype=torch.int32, device=x.device))
        out = flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), window_valid, causal=True,
        ).transpose(1, 2).reshape(B, T, H * Dh)
        return proj_matmul(out, params["o_proj"]), cache_kv

    kv_spec = "bskd" if cache_kv is None else "sbkd"
    T_kv = k_all.shape[1] if cache_kv is None else k_all.shape[0]
    qg = q.reshape(B, T, KV, groups, Dh)
    scores = torch.einsum(f"btkgd,{kv_spec}->bkgts", qg, k_all.to(qg.dtype)).float() * scale
    neg = torch.full((), NEG_INF, dtype=scores.dtype, device=scores.device)
    if kv_valid_mask is not None:
        scores = torch.where(kv_valid_mask[:, None, None, None, :] > 0, scores, neg)
    key_pos = torch.arange(T_kv, device=x.device)[None, :]
    if cache_kv is None:
        q_pos = torch.arange(T, device=x.device)[:, None] + (T_kv - T)
    else:
        q_pos = (cache_position or 0) + torch.arange(T, device=x.device)[:, None]
    if causal and (cache_kv is None or T > 1):
        scores = torch.where(key_pos <= q_pos, scores, neg)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum(f"bkgts,{kv_spec}->btkgd", probs, v_all.to(x.dtype)).reshape(B, T, H * Dh)
    return proj_matmul(out, params["o_proj"]), cache_kv


def init_attention_params(gen: torch.Generator, cfg: TextMoEConfig, *,
                          dtype=torch.bfloat16, device="cuda") -> Dict:
    """Random attention weights made on `device` in `dtype` (scaled normal,
    zero biases), as `init_attention_params` in the JAX package."""
    D, H, KV, Dh = cfg.hidden_size, cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim

    def w(din, dout):
        t = torch.randn(din, dout, generator=gen, dtype=dtype, device=device)
        return t.mul_(din ** -0.5)

    def lin(din, dout):
        return {"w": w(din, dout), "b": torch.zeros(dout, dtype=dtype, device=device)}

    return {
        "q_proj": lin(D, H * Dh),
        "k_proj": lin(D, KV * Dh),
        "v_proj": lin(D, KV * Dh),
        "o_proj": {"w": w(H * Dh, D)},
    }
