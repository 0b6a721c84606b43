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
from ..ops.quant import proj_matmul, wshape
from ..parallel.comm import (chunks_to_rows, copy_to, gather_dim, group_rank, group_size,
                             reduce_from, reduce_scatter, resolve_group, rows_to_chunks)
from ..parallel.mesh import active, batch_spec, tp_group

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
    """Preallocated KV cache, time-major [L, T_max, B, KV, Dh], as in the JAX
    package (`layers.py:70-111`): the decode window [0, w) is a contiguous
    leading slice of each layer.  Written in place.

    int8 storage (dtype "int8"): k and v int8 with per-(position, head)
    symmetric scales k_scale / v_scale [L, T_max, B, KV] f32 (`quantize_kv`);
    attention applies them outside its products, on the scores (K) and on
    the probabilities (V).  The scales are None for a bf16 / f32 cache."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor,
                 k_scale: Optional[torch.Tensor] = None, v_scale: Optional[torch.Tensor] = None):
        self.k = k
        self.v = v
        self.k_scale = k_scale
        self.v_scale = v_scale

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def create(cls, num_layers, batch, max_len, kv_heads, head_dim, *,
               dtype=torch.bfloat16, device="cuda"):
        shape = (num_layers, max_len, batch, kv_heads, head_dim)
        if dtype in (torch.int8, "int8"):
            return cls(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                       torch.zeros(shape[:-1], dtype=torch.float32, device=device))
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    def grow(self, max_len: int) -> "KVCache":
        """A cache of max_len slots holding this one's contents, scales
        included."""
        L, T, B, KV, Dh = self.k.shape
        out = KVCache.create(L, B, max_len, KV, Dh, dtype=self.k.dtype, device=self.k.device)
        out.k[:, :T] = self.k
        out.v[:, :T] = self.v
        if self.quantized:
            out.k_scale[:, :T] = self.k_scale
            out.v_scale[:, :T] = self.v_scale
        return out


def quantize_kv(x: torch.Tensor):
    """Symmetric int8 over the trailing Dh (`layers.py:114-121`): [..., Dh] →
    (q int8, s f32 [...]), s = max(amax, 1e-6) / 127."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
    q = torch.round(x32 / s[..., None]).clamp(-127, 127).to(torch.int8)
    return q, s


def write_slots(dst: torch.Tensor, start, src: torch.Tensor) -> None:
    """dst[start:start + n] = src along dim 0, in place, cast to dst's
    dtype.  start is a host int or a 0-d device tensor; the tensor form
    writes through `index_copy_`, so the position is never read to the host
    (a CUDA graph of the decode step replays it at a moving position)."""
    if isinstance(start, torch.Tensor):
        n = src.shape[0]
        idx = start.reshape(1) if n == 1 else start + torch.arange(n, device=dst.device)
        dst.index_copy_(0, idx, src.to(dst.dtype))
    else:
        dst[start:start + src.shape[0]] = src.to(dst.dtype)


def update_cache_slice(cache_k, cache_v, k_new, v_new, start, cache_ks=None, cache_vs=None):
    """Write [B, T_new, KV, Dh] into per-layer [T_max, B, KV, Dh] slices at
    time offset `start` (a host int or a 0-d device tensor), in place; with
    an int8 cache (cache_ks / cache_vs [T_max, B, KV]) k and v quantize on
    write and their scales land beside them."""
    if cache_ks is not None:
        (qk, sk), (qv, sv) = quantize_kv(k_new), quantize_kv(v_new)
        write_slots(cache_k, start, qk.transpose(0, 1))
        write_slots(cache_v, start, qv.transpose(0, 1))
        write_slots(cache_ks, start, sk.transpose(0, 1))
        write_slots(cache_vs, start, sv.transpose(0, 1))
        return cache_k, cache_v
    write_slots(cache_k, start, k_new.transpose(0, 1))
    write_slots(cache_v, start, v_new.transpose(0, 1))
    return cache_k, cache_v


def attention(
    params: Dict,
    x: torch.Tensor,                 # [B, T, D]
    cos: torch.Tensor,
    sin: torch.Tensor,
    cfg: TextMoEConfig,
    *,
    cache_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # per-layer [T_max, B, KV, Dh]
    cache_position=None,             # host int or 0-d device tensor
    kv_valid_mask: Optional[torch.Tensor] = None,                  # [B, T_kv] 1 = attendable
    causal: bool = True,
    use_flash: Optional[bool] = None,
    decode_emit: bool = False,
    cache_scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # per-layer [T_max, B, KV]
    prefix_kv=None,
    ring=None,
    is_sliding: bool = False,
    seq_parallel: bool = False,
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

    cache_scales: the int8 cache's per-layer (k_scale, v_scale); they scale
    the f32 scores and the probabilities (`layers.py:236-258, 360-388`).

    prefix_kv: per-layer prefix-tuning (k, v), each [n, KV, Dh], post-RoPE
    (`train/peft.py`).  In the no-cache path they go ahead of the fresh
    keys and values, attendable by every row: the window is n + T keys, the
    query row t sits at key n + t, and flash runs with S = n + T
    (`layers.py:191-203`).  With a cache they are ignored: the generate loop
    writes them into slots [0, n).

    is_sliding: this layer attends through the sliding window
    (cfg.sliding_window): keys a window or more behind the query are masked
    in both einsum paths (`layers.py:227-229, 369-380`).  The flash kernel
    does not window, so it is refused for such a layer.

    On an active mesh's model group (`parallel/mesh.py`) the weights hold
    this rank's q heads and the kv heads they read: H and KV are the local
    counts (from the weights' widths), x enters through `copy_to` and the
    o_proj product, a partial sum over the heads, is summed over the group.
    A cache holds the local kv heads.  seq_parallel (Megatron sequence
    parallelism, `models/model.text_model_forward(seq_axis="model")`): the
    o_proj sum is reduce-scattered over the sequence instead, and each model
    rank keeps its T / |model| rows of the output.

    ring: a process group or (mesh, axis), ring attention over it
    (`layers.py:270-301`, `ops/ring_attention.py`), in one of two cases
    (`_ring_splits_rows`):
      * the ranks of the ring hold the same rows (a bare group, the model
        axis, a batch the active mesh does not split, a ring of one rank):
        q, k and v enter the ring's region through `copy_to` (their
        gradients summed over the ring), each rank attends its T / |ring|
        chunk of queries, and the chunks are gathered before o_proj;
      * a (mesh, axis) ring over data or expert while the active mesh
        splits the batch over them: each rank holds its own rows, so q, k,
        v and the key mask are exchanged (`comm.rows_to_chunks`: rank r
        takes chunk r of T of the ring's p·B rows), the ring attends those
        rows, and the output is exchanged back to this rank's rows
        (`comm.chunks_to_rows`), whose gradients come back the same way.
    In both the heads stay this rank's under tensor parallelism.  The
    causal no-cache path only; a sliding layer is refused (the JAX
    package's ring skips the window).

    Returns (out [B, T, D], cache (k, v) / fresh (k, v) / None).
    """
    if ring is not None:
        if cache_kv is not None or prefix_kv is not None or not causal:
            raise ValueError("ring attention takes the causal no-cache path: no cache, no "
                             "prefix keys, causal")
        if is_sliding and cfg.sliding_window:
            raise ValueError("ring attention does not window: refused on a sliding-window "
                             "layer (it would attend the whole causal past)")

    B, T, _ = x.shape
    Dh = cfg.head_dim
    H = wshape(params["q_proj"]["w"])[-1] // Dh
    KV = wshape(params["k_proj"]["w"])[-1] // Dh
    groups = H // KV
    tp = tp_group()
    x = copy_to(x, tp)

    def o_proj(o):
        if seq_parallel:
            return reduce_scatter(proj_matmul(o, params["o_proj"]), tp, 1)
        return reduce_from(proj_matmul(o, params["o_proj"]), tp)

    window = cfg.sliding_window if is_sliding else None
    if window and use_flash:
        raise ValueError("the flash kernel does not window: a sliding layer takes the einsum path")
    scale = Dh ** -0.5

    q = (proj_matmul(x, params["q_proj"]) + params["q_proj"]["b"]).reshape(B, T, H, Dh)
    k = (proj_matmul(x, params["k_proj"]) + params["k_proj"]["b"]).reshape(B, T, KV, Dh)
    v = (proj_matmul(x, params["v_proj"]) + params["v_proj"]["b"]).reshape(B, T, KV, Dh)
    q, k = apply_rope(q, k, cos, sin)

    if ring is not None:
        split = _ring_splits_rows(ring)
        return o_proj(_ring(q, k, v, kv_valid_mask, resolve_group(ring), tp, split)), None

    if prefix_kv is not None and cache_kv is None:
        pk, pv = prefix_kv
        if pk.shape[1] != KV:                       # the whole model's heads: take ours
            k0 = local_kv_start(cfg)
            pk, pv = pk[:, k0:k0 + KV], pv[:, k0:k0 + KV]
        n_pre = pk.shape[0]
        k = torch.cat([pk[None].to(k.dtype).expand(B, n_pre, KV, Dh), k], dim=1)
        v = torch.cat([pv[None].to(v.dtype).expand(B, n_pre, KV, Dh), v], dim=1)
        if kv_valid_mask is not None:
            kv_valid_mask = torch.cat([torch.ones(B, n_pre, dtype=kv_valid_mask.dtype,
                                                  device=kv_valid_mask.device), kv_valid_mask], 1)

    if decode_emit:
        assert T == 1 and cache_kv is not None and kv_valid_mask is not None
        k_all, v_all = cache_kv                               # [T_kv, B, KV, Dh]
        qg = q.reshape(B, KV, groups, Dh)
        self_score = torch.einsum(
            "bkgd,bkd->bkg", qg, k.reshape(B, KV, Dh).to(qg.dtype)).float() * scale
        s = torch.einsum("sbkd,bkgd->sbkg", k_all.to(qg.dtype), qg).float() * scale
        if cache_scales is not None:
            s = s * cache_scales[0][..., None]
        valid = kv_valid_mask > 0                             # [B, T_kv]
        if window:
            slots = torch.arange(k_all.shape[0], device=x.device)
            valid = valid & ((cache_position - slots) < window)[None, :]
        s = torch.where(valid.t()[:, :, None, None], s, torch.full_like(s, NEG_INF))
        all_s = torch.cat([s, self_score[None]], dim=0)
        probs = torch.softmax(all_s, dim=0).to(x.dtype)
        T_kv = k_all.shape[0]
        pv = probs[:T_kv]
        if cache_scales is not None:
            pv = pv * cache_scales[1][..., None].to(pv.dtype)
        o = torch.einsum("sbkg,sbkd->bkgd", pv, v_all.to(x.dtype))
        o = o + probs[T_kv][..., None] * v.reshape(B, KV, 1, Dh).to(x.dtype)
        return o_proj(o.reshape(B, 1, H * Dh)), (k, v)

    if cache_kv is not None:
        k_all, v_all = update_cache_slice(cache_kv[0], cache_kv[1], k, v, cache_position,
                                          *(cache_scales or (None, None)))
        cache_kv = (k_all, v_all)
    else:
        k_all, v_all = k, v

    if use_flash is None:
        # Auto mode never takes flash in cache mode: the window covers only
        # the fresh k/v, which is right solely for a cache_position == 0
        # prefill; the generate loop's prefill opts in with use_flash=True.
        # Nor in a sliding layer.
        use_flash = T >= 128 and causal and cache_kv is None and x.is_cuda and not window
    if use_flash and T > 1 and causal:
        from ..ops.flash_attention import flash_attention

        S_win = k.shape[1]                       # T, or n + T with prefix keys
        window_valid = (
            kv_valid_mask[:, :S_win].to(torch.int32).contiguous() if kv_valid_mask is not None
            else torch.ones(B, S_win, dtype=torch.int32, device=x.device))
        out = flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), window_valid, causal=True,
        ).transpose(1, 2).reshape(B, T, H * Dh)
        return o_proj(out), cache_kv

    kv_spec = "bskd" if cache_kv is None else "sbkd"
    T_kv = k_all.shape[1] if cache_kv is None else k_all.shape[0]
    qg = q.reshape(B, T, KV, groups, Dh)
    scores = torch.einsum(f"btkgd,{kv_spec}->bkgts", qg, k_all.to(qg.dtype)).float() * scale
    if cache_kv is not None and cache_scales is not None:
        scores = scores * cache_scales[0].permute(1, 2, 0)[:, :, None, None, :]
    neg = torch.full((), NEG_INF, dtype=scores.dtype, device=scores.device)
    if kv_valid_mask is not None:
        scores = torch.where(kv_valid_mask[:, None, None, None, :] > 0, scores, neg)
    key_pos = torch.arange(T_kv, device=x.device)[None, :]
    if cache_kv is None:
        q_pos = torch.arange(T, device=x.device)[:, None] + (T_kv - T)
    else:
        q_pos = (0 if cache_position is None else cache_position) + \
            torch.arange(T, device=x.device)[:, None]
    if causal and (cache_kv is None or T > 1):
        scores = torch.where(key_pos <= q_pos, scores, neg)
    if window:
        scores = torch.where((q_pos - key_pos) < window, scores, neg)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    if cache_kv is not None and cache_scales is not None:
        probs = probs * cache_scales[1].permute(1, 2, 0)[:, :, None, None, :].to(probs.dtype)
    out = torch.einsum(f"bkgts,{kv_spec}->btkgd", probs, v_all.to(x.dtype)).reshape(B, T, H * Dh)
    return o_proj(out), cache_kv


def _ring_splits_rows(ring) -> bool:
    """Whether the ranks of a (mesh, axis) ring hold different rows: the
    axis is data or expert (or both), of more than one rank, and the active
    mesh is this one with its batch split over (data, expert).  A bare
    process group keeps the same-rows meaning."""
    if not isinstance(ring, tuple):
        return False
    mesh, axis = ring
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    ctx = active()
    if ctx is None or ctx.mesh is not mesh or not ctx.split_batch:
        return False
    on_rows = [a in batch_spec() for a in axes]
    if any(on_rows) and not all(on_rows):
        raise ValueError(f"ring axes {axes}: a ring over the batch's axes {batch_spec()} "
                         "takes no other axis")
    return all(on_rows) and mesh.size(axes) > 1


def _ring(q, k, v, kv_valid_mask, group, tp, split_rows: bool) -> torch.Tensor:
    """Ring attention of [B, T, ·, Dh] q, k, v over group → [B, T, H·Dh].
    Same rows on every ring rank: this rank's query chunk against every
    chunk, the chunks' outputs gathered along T.  split_rows: the ring's
    rows exchanged for chunks and back (`attention`)."""
    from ..ops.ring_attention import ring_attention

    if group is not None and group is tp:
        raise ValueError("ring attention over the model axis needs tensor parallelism off "
                         "there (the weights whole on every ring rank)")
    B, T, H, Dh = q.shape
    p, r = group_size(group), group_rank(group)
    if T % p:
        raise ValueError(f"ring attention: T {T} does not split over {p} ranks")
    Tc = T // p
    valid = (kv_valid_mask[:, :T].to(torch.int32) if kv_valid_mask is not None
             else torch.ones(B, T, dtype=torch.int32, device=q.device))
    if split_rows:
        q, k, v = (rows_to_chunks(t, group, 1).transpose(1, 2) for t in (q, k, v))
        out = ring_attention(q, k, v, rows_to_chunks(valid, group, 1), group=group,
                             causal=True)
        return chunks_to_rows(out.transpose(1, 2).reshape(p * B, Tc, H * Dh), group, 1)
    cut = slice(r * Tc, (r + 1) * Tc)
    q, k, v = (copy_to(t, group)[:, cut].transpose(1, 2) for t in (q, k, v))
    out = ring_attention(q, k, v, valid[:, cut], group=group, causal=True)
    return gather_dim(out.transpose(1, 2).reshape(B, Tc, H * Dh), group, 1)


def local_kv_start(cfg: TextMoEConfig) -> int:
    """The first kv head of this rank's attention on the active mesh's
    model group (0 without one)."""
    from ..parallel.mesh import active, kv_replicas

    ctx = active()
    if ctx is None or not ctx.tp:
        return 0
    tp = ctx.mesh.shape["model"]
    rep = kv_replicas(cfg, tp)
    return ctx.mesh.coord["model"] // rep * (cfg.num_key_value_heads * rep // tp)


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
