"""Weight quantization and the weight matmuls of the port — counterpart of
`unimoe_audio_tpu/ops/quant.py`.

Symmetric per-output-channel quantization of `[..., D, F]` weights
(contraction dim at axis -2):

  w[..., d, f] ≈ q[..., d, f] · s[..., g, f],   g = d // (D / Dg)

with s `[..., Dg, F]`; Dg == 1 is per-channel, the serving layout, where the
scale commutes out of the product: x @ (q·s) == (x @ q)·s.

  * int8: q in [-127, 127] as int8, s f32 = amax / 127 (`quantize_tensor`);
  * int4: q in [-8, 7] with MSE clip-searched bf16 scales
    (`quantize_tensor_int4`).  Storage is the port's own: two nibbles per
    byte in a uint8 tensor, packed along the output dim F (even column in the
    low nibble), so q has shape [..., D, F / 2]; `qvalues` unpacks with sign
    extension.  (The JAX package's packed s4 is a TPU layout.)

Activations of the a8 expert path quantize per row (`act_quant_int8`).  The
expert weights' q feed `torch._int_mm` (`moe/dispatch.py`), which on an
H100 80GB HBM3 at 700 W (torch 2.11, CUDA 12.8) ran 3-6 x slower with a
row-major [K, N] operand than with a column-major one, and refused the
row-major one at K 64, N 128 (CUBLAS_STATUS_NOT_SUPPORTED).  So expert q
are stored K-major: the [..., D, F] tensor is a transposed view of a
contiguous [..., F, D] one (`kmajor`, applied by `kmajor_experts` wherever
expert QTensors are made); packed int4 the same way, [..., F / 2, D] in
memory.  Other weights stay row-major.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Union

import torch
import torch.nn.functional as F


class QTensor(NamedTuple):
    """Quantized weight: q int8 (the weight's shape) or packed int4 (uint8,
    last dim halved), s f32 (int8) or bf16 (int4) scales [..., Dg, F]."""

    q: torch.Tensor
    s: torch.Tensor


WeightLike = Union[torch.Tensor, QTensor]


def is_int4(w: QTensor) -> bool:
    return w.q.dtype == torch.uint8


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], [..., F] with F even → uint8 [..., F / 2]."""
    if q.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even last dim, got {tuple(q.shape)}")
    q = q.to(torch.int8)
    return ((q[..., 0::2] & 0xF) | (q[..., 1::2] << 4)).view(torch.uint8)


def is_kmajor(t: torch.Tensor) -> bool:
    """Column-major over the last two dims (dim -2 contiguous)."""
    return t.dim() >= 2 and t.stride(-2) == 1 and t.transpose(-1, -2).is_contiguous()


def kmajor(t: torch.Tensor) -> torch.Tensor:
    """t with the same values, column-major over its last two dims."""
    return t if is_kmajor(t) else t.transpose(-1, -2).contiguous().transpose(-1, -2)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """uint8 [..., F / 2] → int8 [..., F], each nibble sign-extended; a
    K-major p unpacks K-major."""
    if is_kmajor(p) and not p.is_contiguous():
        b = p.transpose(-1, -2).view(torch.int8)                     # [..., F / 2, D]
        return torch.stack(((b << 4) >> 4, b >> 4), dim=-2).flatten(-3, -2).transpose(-1, -2)
    b = p.view(torch.int8)
    return torch.stack(((b << 4) >> 4, b >> 4), dim=-1).flatten(-2)


def qvalues(w: QTensor) -> torch.Tensor:
    """The integer values of q as int8, in the weight's shape."""
    return unpack_int4(w.q) if is_int4(w) else w.q


def wshape(w: WeightLike) -> torch.Size:
    """Shape of a raw or quantized weight."""
    if isinstance(w, QTensor):
        return w.q.shape[:-1] + (w.q.shape[-1] * 2,) if is_int4(w) else w.q.shape
    return w.shape


def quantize_tensor(w: torch.Tensor) -> QTensor:
    """Per-output-channel symmetric int8 (`quant.py:46`)."""
    w32 = w.float()
    s = w32.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / 127.0
    q = torch.round(w32 / s).clamp(-127, 127).to(torch.int8)
    return QTensor(q=q, s=s)


def _dequant_grouped(w: QTensor, dtype) -> torch.Tensor:
    """A group-wise QTensor (Dg > 1) dequantized to dtype, original shape
    (`quant.py:60`)."""
    q, s = qvalues(w), w.s
    Dg = s.shape[-2]
    D, Fo = q.shape[-2], q.shape[-1]
    qf = q.to(dtype).reshape(*q.shape[:-2], Dg, D // Dg, Fo)
    return (qf * s[..., :, None, :].to(dtype)).reshape(q.shape)


def dequantize(w: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Any QTensor (per-channel or group-wise) dequantized to dtype."""
    if w.s.shape[-2] > 1:
        return _dequant_grouped(w, dtype)
    return qvalues(w).to(dtype) * w.s.to(dtype)


def matmul(x: torch.Tensor, w: WeightLike) -> torch.Tensor:
    """x @ w for a raw or quantized `[..., D, F]` weight, in x's dtype."""
    if isinstance(w, QTensor):
        if w.s.shape[-2] > 1:
            return x @ _dequant_grouped(w, x.dtype)
        return (x @ qvalues(w).to(x.dtype)) * w.s.to(x.dtype)
    return x @ w.to(x.dtype)


def proj_matmul(x: torch.Tensor, proj: Dict) -> torch.Tensor:
    """x @ proj["w"], plus the LoRA delta (x·a)·b·scale where the dict holds
    lora_a / lora_b / lora_scale (`train/lora.py`; `quant.py:94-101`), over a
    raw or quantized base, in x's dtype."""
    y = matmul(x, proj["w"])
    if "lora_a" in proj:
        delta = (x @ proj["lora_a"].to(x.dtype)) @ proj["lora_b"].to(x.dtype)
        y = y + delta * proj["lora_scale"].to(x.dtype)
    return y


def act_quant_int8(x: torch.Tensor):
    """Per-row symmetric int8 over the last dim (`quant.py:104`): (q int8,
    s f32 [..., 1]) with x ≈ q·s.  Zero rows quantize to q = 0."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    q = torch.round(x32 / s).clamp(-127, 127).to(torch.int8)
    return q, s


def expert_einsum(spec: str, x: torch.Tensor, w: WeightLike) -> torch.Tensor:
    """einsum('ecd,edf->ecf'-style) over stacked raw or quantized expert
    weights (contraction dim of w at axis -2, output dim at -1)."""
    if isinstance(w, QTensor):
        if w.s.shape[-2] > 1:
            return torch.einsum(spec, x, _dequant_grouped(w, x.dtype))
        return torch.einsum(spec, x, qvalues(w).to(x.dtype)) * w.s.to(x.dtype)
    return torch.einsum(spec, x, w.to(x.dtype))


def _group_size_for(D: int, group_size) -> int:
    """Largest divisor of D that is at most group_size; 0 / None / ≥ D means
    per-channel (one group spanning D)."""
    if not group_size or group_size >= D:
        return D
    g = min(group_size, D)
    while D % g:
        g -= 1
    return g


_CLIP_RATIOS = (1.0, 0.95, 0.9, 0.85, 0.8, 0.75, 0.7, 0.65)


def _quantize_grouped_int4_core(w32: torch.Tensor, G: int):
    """Group-wise int4 on the full [-8, 7] grid with an MSE clip search
    (`quant.py:198-232`): for each group of G contraction rows and each
    output column, the scales r·amax/d for r in `_CLIP_RATIOS`, d in {7, 8},
    each rounded to bf16 before it is tried, in that order; strict `<` keeps
    the first minimum.  Returns (q int8 in [-8, 7], s bf16 [..., D/G, F])."""
    D, Fo = w32.shape[-2], w32.shape[-1]
    wg = w32.reshape(*w32.shape[:-2], D // G, G, Fo)
    amax = wg.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8)     # [..., Dg, 1, F]
    best_err = torch.full_like(amax, float("inf"))
    best_s = amax / 7.0
    for r in _CLIP_RATIOS:
        for d in (7.0, 8.0):
            s = (amax * (r / d)).to(torch.bfloat16).float()
            q = torch.round(wg / s).clamp(-8, 7)
            err = (wg - q * s).square().sum(dim=-2, keepdim=True)
            take = err < best_err
            best_err = torch.where(take, err, best_err)
            best_s = torch.where(take, s, best_s)
    q = torch.round(wg / best_s).clamp(-8, 7).to(torch.int8)
    return q.reshape(w32.shape), best_s[..., :, 0, :].to(torch.bfloat16)


def quantize_tensor_int4(w: torch.Tensor, group_size: int = 0) -> QTensor:
    """int4 with MSE-searched scales (`quant.py:235`); group_size 0 (the
    serving default) is per-channel, G > 0 group-wise along D."""
    w32 = w.float()
    q, s = _quantize_grouped_int4_core(w32, _group_size_for(w32.shape[-2], group_size))
    return QTensor(q=pack_int4(q), s=s)


def _moe_groups(node):
    """The dynamic and fixed expert groups of every DCMoE param dict under
    node (dicts holding both "dynamic" and "fixed"), in order."""
    if isinstance(node, dict):
        if "dynamic" in node and "fixed" in node:
            for g in (node["dynamic"], node["fixed"]):
                if isinstance(g, dict) and "gate" in g:
                    yield g
            return
        for v in node.values():
            yield from _moe_groups(v)
    elif isinstance(node, list):
        for v in node:
            yield from _moe_groups(v)


def kmajor_experts(params: Dict) -> Dict:
    """Every expert QTensor's q made K-major (`kmajor`), in place."""
    for g in _moe_groups(params):
        for key in ("gate", "up", "down"):
            w = g.get(key)
            if isinstance(w, QTensor):
                g[key] = QTensor(q=kmajor(w.q), s=w.s)
    return params


def requantize_experts_int4_inplace(params: Dict, group_size: int = 0) -> Dict:
    """The expert FFN QTensors requantized to int4 (`quant.py:265`): each
    dequantized to f32 and clip-searched again, per layer (the port's params
    are one dict per layer, so the f32 transient is one layer's leaf).
    MUTATES and returns params."""
    for g in _moe_groups(params):
        for key in ("gate", "up", "down"):
            if isinstance(g[key], QTensor):
                g[key] = quantize_tensor_int4(dequantize(g[key]), group_size)
    return kmajor_experts(params)


def pad_expert_ffn(params: Dict, multiple: int = 128) -> Dict:
    """Zero-pad the expert FFN intermediate dims up to `multiple`
    (`quant.py:350-429`): gate/up output columns and down contraction rows.
    Exact: silu(0)·0 == 0, and the padded down rows multiply those zeros.
    QTensor leaves pad q with zeros (packed int4 by whole bytes); padded
    output channels get scale 1, and group-wise scales over a padded
    contraction dim get whole groups of 1.  MUTATES and returns params."""

    def pad_leaf(node, key, axis):
        w = node[key]
        Fn = wshape(w)[axis]
        Fp = -(-Fn // multiple) * multiple
        if Fp == Fn:
            return
        n = Fp - Fn
        if not isinstance(w, QTensor):
            node[key] = F.pad(w, (0, n) if axis == -1 else (0, 0, 0, n))
            return
        if axis == -1:
            q = F.pad(w.q, (0, n // 2 if is_int4(w) else n))
            s = F.pad(w.s, (0, n), value=1.0)
        else:
            q = F.pad(w.q, (0, 0, 0, n))
            s = w.s
            if s.shape[-2] > 1:
                G = Fn // s.shape[-2]
                if n % G:
                    raise ValueError(
                        f"contraction pad {n} not a multiple of the scale group size {G}; "
                        "quantize with a group size dividing the padded dim or pad first")
                s = F.pad(s, (0, 0, 0, n // G), value=1.0)
        node[key] = QTensor(q=q, s=s)

    for g in _moe_groups(params):
        pad_leaf(g, "gate", -1)
        pad_leaf(g, "up", -1)
        pad_leaf(g, "down", -2)
    return kmajor_experts(params)


# Leaves quantized by `quantize_model_params`, in the JAX package's paths
# (`quant.py:130-143`); "layers" walks the port's list of per-layer dicts.
_QUANT_PATHS = (
    ("layers", "attn", "q_proj", "w"),
    ("layers", "attn", "k_proj", "w"),
    ("layers", "attn", "v_proj", "w"),
    ("layers", "attn", "o_proj", "w"),
    ("layers", "moe", "dynamic", "gate"),
    ("layers", "moe", "dynamic", "up"),
    ("layers", "moe", "dynamic", "down"),
    ("layers", "moe", "fixed", "gate"),
    ("layers", "moe", "fixed", "up"),
    ("layers", "moe", "fixed", "down"),
    ("codec_head",),
    ("lm_head",),
)


def _quant_slots(params: Dict):
    """(container, key) of every leaf `_QUANT_PATHS` names that exists."""
    for path in _QUANT_PATHS:
        roots = params.get("layers", []) if path[0] == "layers" else [params]
        keys = path[1:] if path[0] == "layers" else path
        for node in roots:
            try:
                for k in keys[:-1]:
                    node = node[k]
                node[keys[-1]]
            except (KeyError, TypeError):
                continue
            yield node, keys[-1]


def _copy_containers(t):
    if isinstance(t, dict):
        return {k: _copy_containers(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_copy_containers(v) for v in t]
    return t


def quantize_model_params_inplace(params: Dict) -> Dict:
    """int8 over the bandwidth-dominant weights (attention projections,
    expert FFNs, output heads), leaf by leaf, dropping each source before
    the next (`quant.py:468-495`).  QTensor leaves (GPTQ experts) are left
    as they are; router, norms, biases and embeddings stay full precision.
    MUTATES and returns params; the caller holds no other reference to the
    replaced leaves."""
    for node, key in _quant_slots(params):
        if not isinstance(node[key], QTensor):
            node[key] = quantize_tensor(node[key])
    return kmajor_experts(params)


def quantize_vision_params(vision: Dict) -> Dict:
    """Int8 per-channel weights for the vision tower (`quant.py:322-347`):
    the patch embed and every projection of the blocks and the merger;
    norms and biases stay as they are.  Returns a new tree (containers
    copied, the other leaves shared)."""

    def q(proj):
        return {**proj, "w": quantize_tensor(proj["w"])}

    return {
        **vision,
        "patch_embed": quantize_tensor(vision["patch_embed"]),
        "blocks": [{**blk, "qkv": q(blk["qkv"]), "proj": q(blk["proj"]),
                    "mlp": {k: q(v) for k, v in blk["mlp"].items()}}
                   for blk in vision["blocks"]],
        "merger": {**vision["merger"], "fc1": q(vision["merger"]["fc1"]),
                   "fc2": q(vision["merger"]["fc2"])},
    }


def quantize_model_params(params: Dict) -> Dict:
    """`quantize_model_params_inplace` on a copy of the containers (leaves
    shared, not copied) (`quant.py:432-465`)."""
    return quantize_model_params_inplace(_copy_containers(params))
