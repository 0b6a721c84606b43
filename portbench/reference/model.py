"""Plain PyTorch reference of the UniMoE-Audio decoder, in float32 with TF32
off, for the benchmark's correctness checks.  It imports nothing of the
program: the equations follow the published model (Qwen2.5-style GQA
attention with q/k/v biases and rotary positions, RMSNorm, the DCMoE block
with Top-P routing over 8 routed experts and a null expert, two always-on
fixed experts, the summed per-channel codec embeddings and the codec head),
and every quantity the program derives from the weights (int8 and int4
quantization, the int8 KV cache) is worked out again here from the weights
the benchmark made.

Two uses:
  * `train_forward`: the loss of a batch of codec rows (per-channel shifted
    cross-entropy summed over channels, plus the load-balancing loss), with
    gradients by autograd, each layer checkpointed so that a batch of
    B x 2048 fits beside nothing else on the card;
  * `serve_logits`: the codec logits of served sequences (prompt, then the
    decode frames), with the program's serving arithmetic stated by the
    configuration: int8 per-channel attention and head weights, int4
    per-channel experts (via int8, with the clip search), int8 per-row
    activations into the experts at decode positions (the prompt's prefill
    multiplies the int4 weights in full precision), an int8 KV cache read
    by every decode position (a position's own key and value, and the
    prompt's keys within the prompt, are read unquantized).

`lowp` selects the control's lower precision: "fp8" computes every matrix
product but the router (f32 by the configuration) in fp8, e4m3 inputs and
an e5m2 gradient, each under a per-tensor scale; "int4" quantizes the
expert activations and the KV cache to 4 bits in place of 8.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1e30
CLIP_RATIOS = (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7, 0.65)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fold_seed(seed: int, n: int) -> int:
    """The program's seed derivation (a numpy SeedSequence of (seed, n)):
    the jitter of training step s in layer i is drawn from
    fold(fold(trainer seed, s), i)."""
    return int(np.random.SeedSequence([seed, n]).generate_state(1, np.uint64)[0] >> 1)


def input_jitter(shape, seed: int, eps: float, device) -> torch.Tensor:
    """Multiplicative router-input noise U(1 - eps, 1 + eps) from a generator
    seeded with `seed` on `device` (the published input jitter; its draw is
    fixed by the seed, so the reference can make the same one)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return u * (2 * eps) + (1 - eps)


# -- lower precision for the control ---------------------------------------
def _fp8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    s = x.abs().amax().clamp_min(1e-30) / top
    return (x / s).to(dtype).float() * s


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale (amax -> 448),
    straight through for the gradient."""
    return x + (_fp8(x.detach(), torch.float8_e4m3fn, 448.0) - x.detach())


class _GradE5M2(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2 under a
    per-tensor scale (amax -> 57344), as fp8 training rounds it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2, 57344.0)


class Prec:
    """Where the matrix products round their operands: nowhere (float32),
    or in fp8 for the control (e4m3 inputs forward, an e5m2 gradient into
    both backward products)."""

    def __init__(self, lowp: Optional[str] = None):
        self.fp8 = lowp == "fp8"
        self.bits = 4 if lowp == "int4" else 8

    def mm(self, a, b):
        if self.fp8:
            return _GradE5M2.apply(fp8_round(a) @ fp8_round(b))
        return a @ b


# -- quantization, worked out again from the weights -----------------------
def quant_int8_channel(w: torch.Tensor) -> torch.Tensor:
    """Symmetric per-output-channel int8 over the contraction dim (-2),
    dequantized: q·s, s = max(amax, 1e-8) / 127."""
    w = w.float()
    s = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(w / s).clamp(-127, 127) * s


def quant_int4_channel(w: torch.Tensor):
    """Per-output-channel int4 on [-8, 7] with the MSE clip search: scales
    r·amax/d for r in CLIP_RATIOS, d in (7, 8), each rounded to bf16, the
    first minimum of the squared error kept.  Returns (q float, s float)."""
    w = w.float()
    amax = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8)
    best_err = torch.full_like(amax, float("inf"))
    best_s = amax / 7.0
    for r in CLIP_RATIOS:
        for d in (7.0, 8.0):
            s = (amax * (r / d)).to(torch.bfloat16).float()
            err = (w - torch.round(w / s).clamp(-8, 7) * s).square().sum(dim=-2, keepdim=True)
            take = err < best_err
            best_err = torch.where(take, err, best_err)
            best_s = torch.where(take, s, best_s)
    return torch.round(w / best_s).clamp(-8, 7), best_s


def expert_int4(w: torch.Tensor):
    """Serving experts: int8 per channel first, then int4 of that."""
    return quant_int4_channel(quant_int8_channel(w))


def act_quant(x: torch.Tensor, bits: int):
    """Per-row symmetric quantization over the last dim: (q, s)."""
    top = 127.0 if bits == 8 else 7.0
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / top
    return torch.round(x / s).clamp(-top, top), s


def kv_quant(x: torch.Tensor, bits: int) -> torch.Tensor:
    """The KV cache's per-(position, head) quantization over Dh, dequantized."""
    top = 127.0 if bits == 8 else 7.0
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-6) / top
    return torch.round(x / s).clamp(-top, top) * s


# -- building blocks ---------------------------------------------------------
def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def rope(pos: torch.Tensor, head_dim: int, theta: float):
    """cos, sin [..., head_dim] of integer positions (text positions: the
    three mRoPE rows coincide, so every section rotates by the same angle)."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64, device=pos.device) / half))
    ang = pos.double()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang).float(), torch.sin(ang).float()


def rotate(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def swiglu(x, g, u, d, prec: Prec):
    return prec.mm(F.silu(prec.mm(x, g)) * prec.mm(x, u), d)


def swiglu_int(x, e, prec: Prec, a8=None):
    """int4 expert e = ((qg, sg), (qu, su), (qd, sd)).  Rows where `a8`
    holds (all rows when it is None) quantize their activations per row:
    exact integer products, rescaled by row x channel scales.  The other
    rows multiply the int4 weights in full precision (the prefill's dense
    dispatch)."""
    (qg, sg), (qu, su), (qd, sd) = e
    if a8 is not None and not bool(a8.all()):
        out = torch.empty_like(x)
        on = a8.nonzero()[:, 0]
        off = (~a8).nonzero()[:, 0]
        if on.numel():
            out[on] = swiglu_int(x[on], e, prec)
        out[off] = (F.silu(x[off] @ (qg * sg)) * (x[off] @ (qu * su))) @ (qd * sd)
        return out
    qx, sx = act_quant(x, prec.bits)
    g = (qx @ qg) * (sx * sg)
    u = (qx @ qu) * (sx * su)
    qh, sh = act_quant(F.silu(g) * u, prec.bits)
    return (qh @ qd) * (sh * sd)


def router_top_k(logits_dyn: torch.Tensor, top_p: float) -> torch.Tensor:
    """Top-P expert count: experts in descending softmax order until the
    cumulative mass reaches top_p, the one that crosses it included."""
    p = torch.sort(torch.softmax(logits_dyn, dim=-1), dim=-1, descending=True).values
    return (torch.cumsum(p, dim=-1) < top_p).sum(dim=-1) + 1


def mixer(scores: torch.Tensor, top_k: torch.Tensor, eps: float):
    """Closed-form routing weights of the DCMoE mixer at inference and in
    training with `ignore_differentiable_router`: round r takes the r-th
    ranked expert (ties by index) with weight exp(v_r) / sum of exp(v_j) over
    the later-ranked experts j not more than 2·eps (relative) below v_r;
    the ranking, the near-set and the shifts carry no gradient."""
    S, E = scores.shape
    idx = torch.arange(E, device=scores.device)
    order = torch.sort(scores.detach(), dim=-1, descending=True, stable=True).indices
    v = torch.gather(scores, 1, order)                               # [S, r] desc
    vs = v.detach()
    factor = torch.maximum(vs.abs()[:, :, None], vs.abs()[:, None, :])
    near = ~(((vs[:, :, None] - vs[:, None, :]) / factor) > 2 * eps)
    include = (idx[None, None, :] >= idx[None, :, None]) & near
    z = torch.exp(v[:, None, :] - vs[:, :, None])
    mult = torch.exp(v - vs) / torch.where(include, z, torch.zeros_like(z)).sum(dim=-1)
    active = idx[None, :] < top_k[:, None]
    w_sorted = torch.where(active, mult, torch.zeros_like(mult))
    w = torch.zeros_like(scores).scatter(1, order, w_sorted)
    mask = torch.zeros(S, E, dtype=torch.bool, device=scores.device).scatter(1, order, active)
    return w, mask


def dcmoe(W: Dict, x: torch.Tensor, tc, prec: Prec, *, noise=None, quantized=False,
          a8=None, stats: Optional[Dict] = None):
    """DCMoE block on tokens x [S, D]: (out [S, D], load-balancing loss).
    quantized: int4 experts, with per-row int8 activations on the tokens
    where `a8` [S] holds (all, when None)."""
    E_dyn, E_real = tc.mlp_dynamic_expert_num + tc.mlp_dynamic_null_expert_num, \
        tc.mlp_dynamic_expert_num
    xr = x if noise is None else x * noise
    logits = xr @ W["router"]                                         # f32 by the config
    dyn = logits[:, :E_dyn]
    top_k = router_top_k(dyn, tc.mlp_dynamic_top_p)
    w, mask = mixer(dyn, top_k, tc.router_jitter_noise)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-6)
    full_mask = torch.cat([mask, torch.ones(x.shape[0], logits.shape[1] - E_dyn,
                                            dtype=torch.bool, device=x.device)], dim=-1)
    # Load-balancing loss over the dynamic (+ null) experts.
    lb = torch.softmax(torch.where(full_mask, logits, torch.full_like(logits,
                                   torch.finfo(torch.float32).min))[:, :E_dyn], dim=-1)
    aux = (mask.float().mean(dim=0) * lb.mean(dim=0)).sum() * E_dyn
    # Global weights: softmax over every selected expert, the dynamic block
    # scaled by its mass.
    gw = torch.softmax(torch.where(full_mask, logits, torch.full_like(logits, NEG)), dim=-1)
    gw = torch.cat([w * gw[:, :E_dyn].sum(dim=-1, keepdim=True), gw[:, E_dyn:]], dim=-1)
    if stats is not None:
        stats["top_k"] = stats.get("top_k", 0.0) + float(top_k.float().sum())
        stats["real"] = stats.get("real", 0.0) + float(mask[:, :E_real].sum())
        stats["tokens"] = stats.get("tokens", 0) + x.shape[0]
    out = torch.zeros_like(x)
    for e in range(E_real):
        sel = mask[:, e].nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        xe = x[sel]
        y = swiglu_int(xe, W["dyn"][e], prec, None if a8 is None else a8[sel]) if quantized else \
            swiglu(xe, W["dyn_gate"][e], W["dyn_up"][e], W["dyn_down"][e], prec)
        out = out.index_add(0, sel, y * gw[sel, e:e + 1])
    for f in range(tc.mlp_fixed_expert_num):
        y = swiglu_int(x, W["fix"][f], prec, a8) if quantized else \
            swiglu(x, W["fix_gate"][f], W["fix_up"][f], W["fix_down"][f], prec)
        out = out + y * gw[:, E_dyn + f:E_dyn + f + 1]
    return out, aux


# -- training ------------------------------------------------------------------
def _train_attention(W, h, cos, sin, tc, prec: Prec):
    B, T, D = h.shape
    H, KV, Dh = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    G = H // KV
    q = (prec.mm(h, W["q_w"]) + W["q_b"]).reshape(B, T, H, Dh)
    k = (prec.mm(h, W["k_w"]) + W["k_b"]).reshape(B, T, KV, Dh)
    v = (prec.mm(h, W["v_w"]) + W["v_b"]).reshape(B, T, KV, Dh)
    q, k = rotate(q, cos[:, :, None], sin[:, :, None]), rotate(k, cos[:, :, None], sin[:, :, None])
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    outs = []
    for b in range(B):
        qb = q[b].reshape(T, KV, G, Dh).permute(1, 2, 0, 3)            # [KV, G, T, Dh]
        kb = k[b].permute(1, 0, 2)[:, None]                             # [KV, 1, T, Dh]
        vb = v[b].permute(1, 0, 2)[:, None]
        s = prec.mm(qb, kb.transpose(-1, -2)) * Dh ** -0.5
        p = torch.softmax(torch.where(causal, s, torch.full_like(s, NEG)), dim=-1)
        outs.append(prec.mm(p, vb).permute(2, 0, 1, 3).reshape(T, H * Dh))
    return prec.mm(torch.stack(outs), W["o_w"])


def _train_layer(W, h, cos, sin, tc, prec: Prec, noise):
    a = _train_attention(W, rms_norm(h, W["input_layernorm"], tc.rms_norm_eps), cos, sin, tc,
                         prec)
    h = h + a
    B, T, D = h.shape
    hn = rms_norm(h, W["post_attention_layernorm"], tc.rms_norm_eps).reshape(B * T, D)
    out, aux = dcmoe(W, hn, tc, prec,
                     noise=None if noise is None else noise.reshape(B * T, D))
    return h + out.reshape(B, T, D), aux


def train_forward(P: Dict, cfg, batch: Dict[str, torch.Tensor], *, step: int, trainer_seed: int,
                  aux_weight: float, lowp: Optional[str] = None):
    """Loss of one batch of codec rows (every position a codec placeholder).
    P: f32 leaves {"layers": [per-layer dict by kind], "codec_embed",
    "codec_head", "norm"}; batch: codec_input_ids, codec_labels [B, T, C].
    The input jitter of step `step` is the published one, drawn from the
    trainer's seed as the program draws it."""
    tc = cfg.text_config
    prec = Prec(lowp)
    ids = batch["codec_input_ids"].long()
    B, T, C = ids.shape
    h = P["codec_embed"][torch.arange(C, device=ids.device), ids].sum(dim=-2)
    pos = torch.arange(T, device=ids.device)[None].expand(B, T)
    cos, sin = rope(pos, tc.head_dim, tc.rope_theta)
    step_seed = fold_seed(trainer_seed, step)
    auxes = []
    for i, W in enumerate(P["layers"]):
        noise = None
        if tc.input_jitter_noise > 0:
            noise = input_jitter((B, T, tc.hidden_size), fold_seed(step_seed, i),
                                 tc.input_jitter_noise, ids.device)
        h, aux = checkpoint(_train_layer, W, h, cos, sin, tc, prec, noise, use_reentrant=False)
        auxes.append(aux)
    h = rms_norm(h, P["norm"], tc.rms_norm_eps)
    logits = prec.mm(h, P["codec_head"]).reshape(B, T, C, -1)
    labels = batch["codec_labels"].long()
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    nll = -torch.gather(logp, -1, labels[:, 1:, :, None])[..., 0]       # [B, T-1, C]
    codec_loss = nll.mean(dim=(0, 1)).sum()
    return codec_loss + aux_weight * torch.stack(auxes).mean()


def routing_stats(P: Dict, cfg, batch: Dict[str, torch.Tensor], *, step: int,
                  trainer_seed: int) -> Dict:
    """Mean expert counts per token and layer of a training batch, forward
    only: top_k (the router's count, the null expert included) and real
    (routed experts that compute)."""
    tc = cfg.text_config
    prec = Prec()
    ids = batch["codec_input_ids"].long()
    B, T, C = ids.shape
    stats: Dict = {}
    with torch.no_grad():
        h = P["codec_embed"][torch.arange(C, device=ids.device), ids].sum(dim=-2)
        pos = torch.arange(T, device=ids.device)[None].expand(B, T)
        cos, sin = rope(pos, tc.head_dim, tc.rope_theta)
        step_seed = fold_seed(trainer_seed, step)
        for i, W in enumerate(P["layers"]):
            noise = None
            if tc.input_jitter_noise > 0:
                noise = input_jitter((B, T, tc.hidden_size), fold_seed(step_seed, i),
                                     tc.input_jitter_noise, ids.device)
            a = _train_attention(W, rms_norm(h, W["input_layernorm"], tc.rms_norm_eps),
                                 cos, sin, tc, prec)
            h = h + a
            hn = rms_norm(h, W["post_attention_layernorm"], tc.rms_norm_eps)
            out, _ = dcmoe(W, hn.reshape(B * T, -1), tc, prec, stats=stats,
                           noise=None if noise is None else noise.reshape(B * T, -1))
            h = h + out.reshape(B, T, -1)
    n = stats["tokens"]
    return {"top_k": stats["top_k"] / n, "real": stats["real"] / n}


# -- serving -------------------------------------------------------------------
def serve_layer_weights(W: Dict[str, torch.Tensor]) -> Dict:
    """One layer's serving weights from its (bf16) weights: int8 attention
    projections (dequantized), int4 experts as (q, s) pairs."""
    out = {k: W[k].float() for k in ("input_layernorm", "post_attention_layernorm",
                                     "q_b", "k_b", "v_b", "router")}
    for k in ("q_w", "k_w", "v_w", "o_w"):
        out[k] = quant_int8_channel(W[k])
    out["dyn"] = [tuple(expert_int4(W[k][e]) for k in ("dyn_gate", "dyn_up", "dyn_down"))
                  for e in range(W["dyn_gate"].shape[0])]
    out["fix"] = [tuple(expert_int4(W[k][f]) for k in ("fix_gate", "fix_up", "fix_down"))
                  for f in range(W["fix_gate"].shape[0])]
    return out


def _serve_attention(W, h, cos, sin, lens, n_text, tc, prec: Prec):
    """h [R, T, D] right-padded rows of lengths `lens`; rows' first
    n_text[r] positions are the prompt.  A decode position reads the keys
    and values of earlier positions through the KV cache's quantization
    and its own unquantized; a prompt position reads the prompt's
    unquantized (the prefill attends its fresh window)."""
    R, T, D = h.shape
    H, KV, Dh = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    G = H // KV
    q = (h @ W["q_w"] + W["q_b"]).reshape(R, T, H, Dh)
    k = (h @ W["k_w"] + W["k_b"]).reshape(R, T, KV, Dh)
    v = (h @ W["v_w"] + W["v_b"]).reshape(R, T, KV, Dh)
    q, k = rotate(q, cos[:, :, None], sin[:, :, None]), rotate(k, cos[:, :, None], sin[:, :, None])
    kq, vq = kv_quant(k, prec.bits), kv_quant(v, prec.bits)
    t = torch.arange(T, device=h.device)
    outs = []
    for r in range(R):
        allowed = (t[None, :] <= t[:, None]) & (t[None, :] < lens[r])
        cached = (t[:, None] >= n_text[r]) & (t[None, :] < t[:, None])      # read via the cache
        qr = q[r].reshape(T, KV, G, Dh).permute(1, 2, 0, 3)
        s_plain = qr @ k[r].permute(1, 2, 0)[:, None]
        s_cache = qr @ kq[r].permute(1, 2, 0)[:, None]
        s = torch.where(cached, s_cache, s_plain) * Dh ** -0.5
        p = torch.softmax(torch.where(allowed, s, torch.full_like(s, NEG)), dim=-1)
        pc = torch.where(cached, p, torch.zeros_like(p))
        o = (p - pc) @ v[r].permute(1, 0, 2)[:, None] + pc @ vq[r].permute(1, 0, 2)[:, None]
        outs.append(o.permute(2, 0, 1, 3).reshape(T, H * Dh))
    return torch.stack(outs) @ W["o_w"]


@torch.no_grad()
def serve_logits(layer_weights, outer: Dict, cfg, rows: List[Dict], *, lowp=None,
                 stats: Optional[Dict] = None) -> List[torch.Tensor]:
    """Codec logits [n_dec, C, Vc] at the decode positions of each row.
    rows: {"text": int ids of the prompt's attended tokens, "frames": [n, C]
    decode input frames}.  layer_weights(i) gives layer i's bf16 weights
    (made again from the seed), so that one layer at a time is on the card;
    outer: embed_tokens, codec_embed, norm, codec_head."""
    tc = cfg.text_config
    prec = Prec(lowp)
    dev = outer["codec_embed"].device
    C = cfg.codec_channels
    lens = [len(r["text"]) + len(r["frames"]) for r in rows]
    n_text = [len(r["text"]) for r in rows]
    R, T = len(rows), max(lens)
    h = torch.zeros(R, T, tc.hidden_size, device=dev)
    for i, r in enumerate(rows):
        text = torch.as_tensor(np.asarray(r["text"]), device=dev).long()
        frames = torch.as_tensor(np.asarray(r["frames"]), device=dev).long()
        h[i, :len(text)] = outer["embed_tokens"][text].float()
        h[i, len(text):lens[i]] = outer["codec_embed"][torch.arange(C, device=dev),
                                                       frames].float().sum(dim=-2)
    pos = torch.arange(T, device=dev)[None].expand(R, T)
    cos, sin = rope(pos, tc.head_dim, tc.rope_theta)
    t_idx = torch.arange(T, device=dev)[None, :]
    valid = t_idx < torch.as_tensor(lens, device=dev)[:, None]
    decode = t_idx >= torch.as_tensor(n_text, device=dev)[:, None]     # a8 on decode tokens
    for i in range(tc.num_hidden_layers):
        W = serve_layer_weights(layer_weights(i))
        a = _serve_attention(W, rms_norm(h, W["input_layernorm"], tc.rms_norm_eps), cos, sin,
                             lens, n_text, tc, prec)
        h = h + a
        hn = rms_norm(h, W["post_attention_layernorm"], tc.rms_norm_eps)
        flat = hn[valid]
        out, _ = dcmoe(W, flat, tc, prec, quantized=True, a8=decode[valid], stats=stats)
        delta = torch.zeros_like(h)
        delta[valid] = out
        h = h + delta
        del W
    h = rms_norm(h, outer["norm"].float(), tc.rms_norm_eps)
    head = quant_int8_channel(outer["codec_head"])
    out = []
    for i in range(R):
        hd = h[i, n_text[i]:lens[i]]
        out.append((hd @ head).reshape(hd.shape[0], C, -1))
    return out


def guided(uncond: torch.Tensor, cond: torch.Tensor, scale: float) -> torch.Tensor:
    """Classifier-free guidance of a [neg, cond] pair's logits."""
    return cond + scale * (cond - uncond) if scale != 0 else cond


def lr_at(count: int, lr: float, warmup: int, total: int) -> float:
    """Warmup from 0 over `warmup` updates, then cosine decay to 0 at
    `total` (optax's warmup_cosine_decay_schedule)."""
    if count < warmup:
        return lr * count / warmup
    decay = max(total, warmup + 1) - warmup
    c = min(count - warmup, decay)
    return lr * 0.5 * (1 + math.cos(math.pi * c / decay))
