"""Qwen2.5-VL vision tower of the port — counterpart of
`unimoe_audio_tpu/models/vision.py`.

The patch embed is one matmul of flattened patches (the reference's conv3d
has kernel == stride, so the two are equal); windowed attention is a
block-diagonal boolean mask over the window-shuffled sequence, and the
full-attention blocks (`VisionConfig.fullatt_block_indexes`) use the
per-sample mask instead.  Both masks are [S, S] and are built once per
tower call.  Attention is a masked einsum with the softmax in f32, as in
the JAX package's XLA code (no Pallas kernel there, so no hand-written
kernel here).  Projections go through `ops.quant.matmul`, so int8 QTensor
weights (`ops.quant.quantize_vision_params`) work.

The host-side index code (rope ids, the window shuffle, sample ids) is
numpy, run per call: its shapes depend on the data and are small.

Parameters:
  {"patch_embed": [C·tps·ps·ps, D],
   "blocks": [ {"norm1": [D], "norm2": [D], "qkv": {"w": [D, 3D], "b": [3D]},
                "proj": {"w", "b"}, "mlp": {"gate", "up", "down": {"w", "b"}}},
               ... depth entries ],
   "merger": {"ln_q": [D], "fc1": {"w": [D·m², D·m²], "b"},
              "fc2": {"w": [D·m², out_hidden], "b"}}}
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import VisionConfig
from ..ops.quant import QTensor, matmul
from .layers import rms_norm, rotate_half

# ---------------------------------------------------------------------------
# Host-side index computation (numpy)
# ---------------------------------------------------------------------------


def rot_pos_ids(grid_thw: np.ndarray, spatial_merge_size: int) -> np.ndarray:
    """(h, w) position ids per patch in merger order.  Returns [S, 2] int32."""
    pos_ids = []
    for t, h, w in np.asarray(grid_thw):
        m = spatial_merge_size
        hpos = np.arange(h)[:, None].repeat(w, axis=1)
        hpos = hpos.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.arange(w)[None, :].repeat(h, axis=0)
        wpos = wpos.reshape(h // m, m, w // m, m).transpose(0, 2, 1, 3).reshape(-1)
        pos_ids.append(np.tile(np.stack([hpos, wpos], axis=-1), (t, 1)))
    return np.concatenate(pos_ids, axis=0).astype(np.int32)


def window_index(grid_thw: np.ndarray, cfg: VisionConfig) -> Tuple[np.ndarray, np.ndarray]:
    """Window-shuffle order and the window id of each merged position after
    the shuffle: (index [S_merged], window_id [S_merged]) int32, with
    S_merged = Σ t·(h/m)·(w/m).  Windows at the right and bottom edges are
    ragged where h/m or w/m is no multiple of the window."""
    m = cfg.spatial_merge_size
    vit_ws = cfg.window_size // m // cfg.patch_size
    index_list: List[np.ndarray] = []
    window_ids: List[np.ndarray] = []
    offset = 0
    wid_offset = 0
    for t, h, w in np.asarray(grid_thw):
        gh, gw = h // m, w // m
        idx = np.arange(t * gh * gw).reshape(t, gh, gw)
        pad_h = (-gh) % vit_ws
        pad_w = (-gw) % vit_ws
        nh, nw = (gh + pad_h) // vit_ws, (gw + pad_w) // vit_ws
        padded = np.full((t, gh + pad_h, gw + pad_w), -100, dtype=np.int64)
        padded[:, :gh, :gw] = idx
        padded = padded.reshape(t, nh, vit_ws, nw, vit_ws).transpose(0, 1, 3, 2, 4)
        padded = padded.reshape(t, nh * nw, vit_ws * vit_ws)
        for ti in range(t):
            for wi in range(nh * nw):
                vals = padded[ti, wi]
                vals = vals[vals != -100]
                index_list.append(vals + offset)
                window_ids.append(np.full(len(vals), wid_offset, dtype=np.int64))
                wid_offset += 1
        offset += t * gh * gw
    return (np.concatenate(index_list).astype(np.int32),
            np.concatenate(window_ids).astype(np.int32))


def sample_ids(grid_thw: np.ndarray) -> np.ndarray:
    """The sample index of each patch."""
    return np.concatenate([np.full(t * h * w, i, dtype=np.int32)
                           for i, (t, h, w) in enumerate(np.asarray(grid_thw))])


def sample_ids_merged(grid_thw: np.ndarray, m: int) -> np.ndarray:
    """The sample index of each merged patch."""
    return np.concatenate([np.full(t * (h // m) * (w // m), i, dtype=np.int32)
                           for i, (t, h, w) in enumerate(np.asarray(grid_thw))])


def vision_indices(grid_thw: np.ndarray, cfg: VisionConfig,
                   pad_merged_to: int = 0) -> Dict[str, np.ndarray]:
    """Everything data-dependent about a vision batch, as numpy arrays for
    `vision_tower_apply`.  With pad_merged_to above the merged count the
    tail is padded: padding patches get window and sample id -1 (they attend
    only each other and nobody real attends them) and shuffle and reverse
    to themselves.

    Returns: pos [Sp, 2] rope ids (shuffled order), win_ids [Sp],
    sample_ids [Sp], widx [Smp], reverse [Smp], n_merged (the real count)."""
    m2 = cfg.spatial_merge_size ** 2
    pos = rot_pos_ids(grid_thw, cfg.spatial_merge_size)
    widx, wid = window_index(grid_thw, cfg)
    n_merged = len(widx)
    S = n_merged * m2
    pos = pos.reshape(n_merged, m2, 2)[widx].reshape(S, 2)
    wid_patch = np.repeat(wid, m2)
    sid_patch = np.repeat(sample_ids_merged(grid_thw, cfg.spatial_merge_size)[widx], m2)
    reverse = np.argsort(widx)
    if pad_merged_to and pad_merged_to > n_merged:
        pm = pad_merged_to
        pad_m = pm - n_merged
        pos = np.concatenate([pos, np.zeros((pad_m * m2, 2), pos.dtype)])
        wid_patch = np.concatenate([wid_patch, np.full(pad_m * m2, -1, wid_patch.dtype)])
        sid_patch = np.concatenate([sid_patch, np.full(pad_m * m2, -1, sid_patch.dtype)])
        widx = np.concatenate([widx, np.arange(n_merged, pm, dtype=widx.dtype)])
        reverse = np.concatenate([reverse, np.arange(n_merged, pm, dtype=reverse.dtype)])
    return {
        "pos": pos.astype(np.int32),
        "win_ids": wid_patch.astype(np.int32),
        "sample_ids": sid_patch.astype(np.int32),
        "widx": widx.astype(np.int32),
        "reverse": reverse.astype(np.int32),
        "n_merged": n_merged,
    }


# ---------------------------------------------------------------------------
# Device side (torch)
# ---------------------------------------------------------------------------


def _vision_rope(pos_ids: torch.Tensor, head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """2-D rotary embedding: the first half of the frequencies take the h
    position, the second half the w position (theta 1e4).  pos_ids [S, 2]
    → cos, sin [S, head_dim] f32."""
    quarter = head_dim // 4
    inv_freq = 1.0 / (10000.0 ** (torch.arange(quarter, dtype=torch.float32,
                                               device=pos_ids.device) / quarter))
    h_ang = pos_ids[:, 0:1].float() * inv_freq[None]
    w_ang = pos_ids[:, 1:2].float() * inv_freq[None]
    ang = torch.cat([h_ang, w_ang], dim=-1)                # [S, head_dim / 2]
    emb = torch.cat([ang, ang], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _linear(x: torch.Tensor, p: Dict) -> torch.Tensor:
    """x·W + b; a bias of a wider dtype widens the result, as in JAX."""
    return matmul(x, p["w"]) + p["b"]


def _gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU, written 0.5·x·erfc(-x/√2) as JAX writes it:
    the same function as F.gelu(approximate="none"), rounded closer to the
    JAX package's (within an ulp, against 4 for F.gelu on the CPU)."""
    return 0.5 * x * torch.special.erfc(-x * 0.5 ** 0.5)


def vision_block(p: Dict, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                 attn_mask: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """One ViT block: RMSNorm → attention under attn_mask [S, S] (bool,
    True = attend) → RMSNorm → SwiGLU, each with its residual."""
    S, D = x.shape
    H = cfg.num_heads
    Dh = D // H
    h = rms_norm(x, p["norm1"])
    q, k, v = _linear(h, p["qkv"]).view(S, 3, H, Dh).unbind(1)     # [S, H, Dh]
    cos_ = cos[:, None, :].to(q.dtype)
    sin_ = sin[:, None, :].to(q.dtype)
    q = q * cos_ + rotate_half(q) * sin_
    k = k * cos_ + rotate_half(k) * sin_
    scores = torch.einsum("shd,thd->hst", q, k).float() * (Dh ** -0.5)
    scores = torch.where(attn_mask[None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    dt = torch.promote_types(probs.dtype, v.dtype)
    out = torch.einsum("hst,thd->shd", probs.to(dt), v.to(dt)).reshape(S, D)
    # (x + x·W) + b: the JAX package's order of the sums.
    x = x + matmul(out, p["proj"]["w"]) + p["proj"]["b"]
    h = rms_norm(x, p["norm2"])
    g = _linear(h, p["mlp"]["gate"])
    u = _linear(h, p["mlp"]["up"])
    down = p["mlp"]["down"]
    return x + matmul(F.silu(g) * u, down["w"]) + down["b"]


def vision_tower_apply(params: Dict, patches: torch.Tensor, pos: torch.Tensor,
                       win_ids: torch.Tensor, sample_ids: torch.Tensor, widx: torch.Tensor,
                       reverse: torch.Tensor, cfg: VisionConfig) -> torch.Tensor:
    """Patch embed → window shuffle → blocks → merger → unshuffle, on index
    tensors from `vision_indices`.  patches [Sp, patch_dim] → [Smp,
    out_hidden] in the original merged-patch order."""
    m2 = cfg.spatial_merge_size ** 2
    S = patches.shape[0]
    cos, sin = _vision_rope(pos, cfg.head_dim)
    win_mask = win_ids[:, None] == win_ids[None, :]
    full_mask = sample_ids[:, None] == sample_ids[None, :]

    pe = params["patch_embed"]
    in_dtype = pe.q.dtype if isinstance(pe, QTensor) else pe.dtype
    x = matmul(patches.to(torch.bfloat16 if in_dtype == torch.int8 else in_dtype), pe)
    x = x.reshape(S // m2, m2, -1)[widx.long()].reshape(S, -1)
    for i, blk in enumerate(params["blocks"]):
        mask = full_mask if i in cfg.fullatt_block_indexes else win_mask
        x = vision_block(blk, x, cos, sin, mask, cfg)

    h = rms_norm(x, params["merger"]["ln_q"]).reshape(S // m2, -1)
    h = _gelu_exact(_linear(h, params["merger"]["fc1"]))
    h = _linear(h, params["merger"]["fc2"])
    return h[reverse.long()]


def vision_forward(params: Dict, pixel_patches: torch.Tensor, grid_thw: np.ndarray,
                   cfg: VisionConfig) -> torch.Tensor:
    """The whole tower on flattened patches [S, C·tps·ps·ps] of the grids
    grid_thw [n, 3] (host numpy): features [S / m², out_hidden] in the
    original patch order, on the patches' device."""
    idx = vision_indices(np.asarray(grid_thw), cfg)
    dev = pixel_patches.device
    t = {k: torch.as_tensor(idx[k], device=dev)
         for k in ("pos", "win_ids", "sample_ids", "widx", "reverse")}
    return vision_tower_apply(params, pixel_patches, t["pos"], t["win_ids"], t["sample_ids"],
                              t["widx"], t["reverse"], cfg)


def init_vision_params(cfg: VisionConfig, *, seed: int = 0, dtype=torch.bfloat16,
                       device="cuda") -> Dict:
    """Random tower weights made on `device` from a seeded torch.Generator
    there: linear weights N(0, 1/fan_in), zero biases, unit norms (the JAX
    package's `init_vision_params` layout and scales; other numbers)."""
    D, Fd = cfg.hidden_size, cfg.intermediate_size
    patch_dim = cfg.in_channels * cfg.temporal_patch_size * cfg.patch_size ** 2
    m2 = cfg.spatial_merge_size ** 2
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def nrm(din, dout):
        return torch.randn(din, dout, generator=gen, dtype=dtype, device=device).mul_(din ** -0.5)

    def lin(din, dout):
        return {"w": nrm(din, dout), "b": torch.zeros(dout, dtype=dtype, device=device)}

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    blocks = [{
        "norm1": ones(D),
        "norm2": ones(D),
        "qkv": lin(D, 3 * D),
        "proj": lin(D, D),
        "mlp": {"gate": lin(D, Fd), "up": lin(D, Fd), "down": lin(Fd, D)},
    } for _ in range(cfg.depth)]
    return {
        "patch_embed": nrm(patch_dim, D),
        "blocks": blocks,
        "merger": {"ln_q": ones(D), "fc1": lin(D * m2, D * m2),
                   "fc2": lin(D * m2, cfg.out_hidden_size)},
    }
