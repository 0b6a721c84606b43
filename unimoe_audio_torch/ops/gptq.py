"""Error-compensated int4 expert quantization (GPTQ) — counterpart of
`unimoe_audio_tpu/ops/gptq.py`.

Given the calibration Hessian H = XᵀX over a weight's contraction dim,
GPTQ quantizes the contraction rows one at a time and folds each row's
rounding error into the rows not yet quantized through the upper Cholesky
factor U of H⁻¹, so that correlated input directions absorb each other's
error: it minimises the output error ||XW - XŴ|| rather than the weight
error.  Rows go in blocks of G (128 in the default per-channel mode, whose
one clip-searched scale per output column is fixed up front from the
original weights; the scale group otherwise); inside a block a loop over
rows, batched over the experts of a leaf, and after it one product carries
the block's error to the later rows.

Calibration inputs come from the model (`text_model_forward(...,
output_moe_inputs=True)`): each layer's DCMoE block input X calibrates the
gate and up projections of every expert; the down projection of each
expert is calibrated on silu(X·gate)·(X·up) through its already-quantized
gate and up.  All in f32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .quant import (QTensor, _group_size_for, _quantize_grouped_int4_core, kmajor_experts,
                    matmul, pack_int4)


def _cholesky_inv_upper(H: torch.Tensor, damp_frac: float = 0.01) -> torch.Tensor:
    """Upper Cholesky factor of (H + damp·I)⁻¹, f32 [..., D, D]
    (`gptq.py:47-55`): damp = damp_frac x mean diagonal, + 1e-8; the
    inverse is symmetrised before the factorisation."""
    D = H.shape[-1]
    damp = damp_frac * torch.diagonal(H, dim1=-2, dim2=-1).mean(dim=-1)
    eye = torch.eye(D, dtype=H.dtype, device=H.device)
    Hinv = torch.linalg.inv(H + (damp[..., None, None] + 1e-8) * eye)
    Hinv = 0.5 * (Hinv + Hinv.transpose(-1, -2))
    return torch.linalg.cholesky(Hinv).transpose(-1, -2)


def _gptq_core(w32: torch.Tensor, U: torch.Tensor, G: int, per_channel: bool = False):
    """GPTQ of a batch of matrices (`gptq.py:58-118`): w32 [B, D, F] f32, U
    [B, D, D] upper triangular.  Returns (q int8 in [-8, 7] [B, D, F], s
    bf16 [B, D/G, F], or [B, 1, F] per-channel)."""
    W = w32.clone()
    Bn, D, Fo = W.shape
    q = torch.empty(Bn, D, Fo, dtype=torch.int8, device=W.device)
    scales = []
    if per_channel:
        s_pc = _quantize_grouped_int4_core(w32, D)[1]                   # [B, 1, F] bf16
    for i0 in range(0, D, G):
        i1 = i0 + G
        if per_channel:
            s = s_pc
        else:
            s = _quantize_grouped_int4_core(W[:, i0:i1], G)[1]         # this block's scales
        s32 = s.float()[:, 0]                                          # [B, F]
        err = torch.empty(Bn, G, Fo, dtype=W.dtype, device=W.device)
        for i in range(G):
            r = i0 + i
            wi = W[:, r]                                               # [B, F]
            qi = torch.round(wi / s32).clamp(-8, 7)
            di = U[:, r, r]
            ei = (wi - qi * s32) / torch.where(di.abs() > 1e-12, di, torch.ones_like(di))[:, None]
            # The error of row r goes to the later rows of this block.
            W[:, r + 1:i1] -= U[:, r, r + 1:i1, None] * ei[:, None, :]
            err[:, i] = ei
            q[:, r] = qi.to(torch.int8)
        if i1 < D:
            # ... and to every row after the block, in one product.
            W[:, i1:] -= U[:, i0:i1, i1:].transpose(-1, -2) @ err
        scales.append(s)
    return q, (scales[0] if per_channel else torch.cat(scales, dim=-2))


def _gptq_int4_raw(w: torch.Tensor, H: torch.Tensor, group_size: int):
    """GPTQ int4 of w [..., D, F] against H over the contraction dim
    (`gptq.py:121-149`).  H's leading dims align with w's leading ones,
    layer-major: [D, D] is shared by every matrix, [L, D, D] by the experts
    of an [L, E, D, F] leaf.  group_size 0 is per-channel (error
    compensation in 128-row blocks).  Returns (q int8, s bf16)."""
    w32 = w.float()
    D = w32.shape[-2]
    per_channel = not group_size or group_size >= D
    G = _group_size_for(D, 128 if per_channel else group_size)
    U = _cholesky_inv_upper(H.float())
    while U.dim() < w32.dim():
        U = U[..., None, :, :]
    lead = w32.shape[:-2]
    U = U.expand(*lead, D, D).reshape(-1, D, D)
    q, s = _gptq_core(w32.reshape(-1, D, w32.shape[-1]), U, G, per_channel)
    return q.reshape(w32.shape), s.reshape(*lead, *s.shape[-2:])


def gptq_quantize_int4(w: torch.Tensor, H: torch.Tensor, group_size: int = 0) -> QTensor:
    """GPTQ int4 QTensor, interchangeable with `quant.quantize_tensor_int4`'s
    (`gptq.py:152-161`)."""
    q, s = _gptq_int4_raw(w, H, group_size)
    return QTensor(q=pack_int4(q), s=s)


@torch.no_grad()
def collect_moe_calibration(params: Dict, cfg, input_ids: torch.Tensor, *,
                            codec_input_ids: Optional[torch.Tensor] = None,
                            attention_mask: Optional[torch.Tensor] = None,
                            max_calib_tokens: int = 4096) -> torch.Tensor:
    """Per-layer DCMoE block inputs X [L, N, D] f32 over a calibration
    batch, padding positions dropped, N ≤ max_calib_tokens
    (`gptq.py:169-201`)."""
    from ..models.model import calculate_input_embedding, text_model_forward

    B, T = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones(B, T, dtype=torch.int32, device=input_ids.device)
    embeds = calculate_input_embedding(params, input_ids, codec_input_ids,
                                       cfg.codec_placeholder_value)
    pos = torch.cumsum(attention_mask, dim=-1) - 1
    pos = torch.where(attention_mask == 0, torch.ones_like(pos), pos)
    x = text_model_forward(params, embeds, pos[None].expand(3, B, T), cfg.text_config,
                           kv_valid_mask=attention_mask, padding_token_mask=attention_mask,
                           output_moe_inputs=True).moe_inputs                  # [L, B, T, D]
    keep = attention_mask.reshape(-1).bool()
    return x.reshape(x.shape[0], B * T, -1)[:, keep][:, :max_calib_tokens]


def collect_moe_hessians(params: Dict, cfg, input_ids: torch.Tensor, *,
                         codec_input_ids: Optional[torch.Tensor] = None,
                         attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-layer Hessians H [L, D, D] = X_lᵀ X_l (`gptq.py:204-217`)."""
    X = collect_moe_calibration(params, cfg, input_ids, codec_input_ids=codec_input_ids,
                                attention_mask=attention_mask)
    return torch.einsum("lsd,lse->lde", X, X)


def _expert_act(x: torch.Tensor, gate, up) -> torch.Tensor:
    """silu(x @ gate) * (x @ up): a down projection's input, through the
    quantized gate and up (`gptq.py:220-226`)."""
    return F.silu(matmul(x, gate)) * matmul(x, up)


@torch.no_grad()
def quantize_experts_int4_gptq(params: Dict, cfg, calib_input_ids: torch.Tensor, *,
                               codec_input_ids: Optional[torch.Tensor] = None,
                               attention_mask: Optional[torch.Tensor] = None,
                               group_size: int = 0, max_calib_tokens: int = 4096,
                               pad_multiple: Optional[int] = 128) -> Dict:
    """The expert FFN weights converted to error-compensated int4
    (`gptq.py:229-314`), layer by layer: gate and up against the layer's
    Hessian XᵀX, then each expert's down against the Hessian of its input
    through the now-quantized gate and up.  The intermediate dim is
    zero-padded to `pad_multiple` first (exact), so a later `pad_expert_ffn`
    leaves the experts alone.  Dynamic and fixed groups alike.  MUTATES and
    returns params."""
    X = collect_moe_calibration(params, cfg, calib_input_ids, codec_input_ids=codec_input_ids,
                                attention_mask=attention_mask,
                                max_calib_tokens=max_calib_tokens)
    for l, lp in enumerate(params["layers"]):
        Xl = X[l]
        Hl = Xl.T @ Xl
        for gname in ("dynamic", "fixed"):
            grp = lp["moe"].get(gname)
            if not isinstance(grp, dict) or "gate" not in grp:
                continue
            Fn = grp["gate"].shape[-1]
            n = (-(-Fn // pad_multiple) * pad_multiple - Fn) if pad_multiple else 0
            gq, gs = _gptq_int4_raw(F.pad(grp["gate"].float(), (0, n)), Hl, group_size)
            uq, us = _gptq_int4_raw(F.pad(grp["up"].float(), (0, n)), Hl, group_size)
            gate, up = QTensor(q=pack_int4(gq), s=gs), QTensor(q=pack_int4(uq), s=us)
            act = _expert_act(Xl[None], gate, up)                              # [E, N, Fp]
            H_down = act.transpose(-1, -2) @ act
            del act
            dq, ds = _gptq_int4_raw(F.pad(grp["down"].float(), (0, 0, 0, n)), H_down,
                                    group_size)
            grp.update(gate=gate, up=up, down=QTensor(q=pack_int4(dq), s=ds))
    return kmajor_experts(params)
