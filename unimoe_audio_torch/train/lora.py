"""LoRA adapters of the port — counterpart of `unimoe_audio_tpu/train/lora.py`.

`add_lora` plants low-rank factors beside the targeted attention
projections' weights: lora_a [din, r], lora_b [r, dout] and lora_scale α/r
(a 0-d tensor) in each layer's projection dict (the JAX package's
layer-stacked [L, din, r] / [L, r, dout] / [L], one layer per dict here).
`ops.quant.proj_matmul` then computes y = x·W + (x·a)·b·scale over a raw or
int8 base.  Train with `trainable_pattern="lora"` so only the adapters move;
`merge_lora` folds them into the base for serving.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Sequence, Tuple

import torch

from ..models.model import fold_seed
from ..ops.quant import QTensor, wshape

DEFAULT_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj")


def _targets(node, targets, path: Tuple[str, ...], out: Dict[str, List], stacked: bool = False):
    """Collect every targeted projection dict as out[path] = [(parent, key,
    stacked)], in order; list indices (the per-layer dicts) do not enter the
    path, so one path gathers the same projection of every layer."""
    if isinstance(node, dict):
        for k, v in node.items():
            if k in targets and isinstance(v, dict) and "w" in v:
                out.setdefault("/".join(path + (k,)), []).append((node, k, stacked))
            else:
                _targets(v, targets, path + (k,), out, stacked)
    elif isinstance(node, list):
        for v in node:
            _targets(v, targets, path, out, True)


def _copy_containers(t):
    if isinstance(t, dict):
        return {k: _copy_containers(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_copy_containers(v) for v in t]
    return t


def add_lora(params: Dict, seed: int = 0, *, rank: int = 8, alpha: float = 16.0,
             targets: Sequence[str] = DEFAULT_TARGETS, dtype=torch.float32) -> Dict:
    """params with LoRA factors in the targeted projection dicts (a new tree:
    containers copied, the other leaves shared), on each weight's device.
    a ~ N(0, 1)·din^-½ from a torch.Generator seeded per projection path by
    fold_seed(seed, crc32(path) mod 2³¹) — crc32, not hash(), which Python
    salts per process — one [L, din, r] draw for the L layers of a path; b
    is 0 and lora_scale α/r, as `add_lora` in the JAX package
    (`lora.py:26-73`)."""
    out = _copy_containers(params)
    found: Dict[str, List] = {}
    _targets(out, tuple(targets), (), found)
    for path, slots in found.items():
        w = slots[0][0][slots[0][1]]["w"]
        din, dout = wshape(w)[-2], wshape(w)[-1]
        dev = (w.q if isinstance(w, QTensor) else w).device
        gen = torch.Generator(device=dev)
        gen.manual_seed(fold_seed(seed, zlib.crc32(path.encode()) % (2 ** 31)))
        a = torch.randn(len(slots), din, rank, generator=gen, device=dev).mul_(din ** -0.5)
        for i, (parent, key, _) in enumerate(slots):
            parent[key] = {
                **parent[key],
                "lora_a": a[i].to(dtype),
                "lora_b": torch.zeros(rank, dout, dtype=dtype, device=dev),
                "lora_scale": torch.full((), alpha / rank, dtype=dtype, device=dev),
            }
    return out


def merge_lora(params: Dict) -> Dict:
    """The adapters folded into the base weights, w + (a·b)·scale summed in
    f32 and cast to w's dtype, and the factors dropped (a new tree), as
    `merge_lora` in the JAX package (`lora.py:79-103`); a quantized base is
    refused: merge before quantizing."""
    if isinstance(params, dict):
        if "lora_a" in params and "w" in params:
            w = params["w"]
            assert not isinstance(w, QTensor), (
                "merge into int8 base unsupported — merge before quantizing")
            delta = (params["lora_a"] @ params["lora_b"]) * params["lora_scale"]
            merged = {k: v for k, v in params.items()
                      if k not in ("lora_a", "lora_b", "lora_scale")}
            merged["w"] = (w.float() + delta.float()).to(w.dtype)
            return merged
        return {k: merge_lora(v) for k, v in params.items()}
    if isinstance(params, list):
        return [merge_lora(v) for v in params]
    return params
