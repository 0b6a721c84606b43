"""Serving snapshots: the quantized serving params, config and modes on disk,
so that a restart skips the quantization pass (and for "int4-gptq" the
self-calibration) — counterpart of `unimoe_audio_tpu/core/export.py:84-149`.

The port writes `serving.torch.pkl`, a pickle that numpy alone reads:

  {"config": dict, "serving_mode": ..., "kv_cache_dtype": ...,
   "params": tree in the JAX package's layout (layer-stacked [L, ...];
             the vision tower's blocks, where present, a list)}

with each leaf a numpy array, or {"__bf16__": uint16 bits} for bf16, or a
quantized leaf {"__qtensor__": True, "int4": bool, "q": int8 values or, for
int4, "q_packed": the port's packed uint8 bytes [..., D, F / 2], "s":
leaf}.  It also reads the JAX package's `serving.jax.pkl`: the same tree
with numpy leaves, int4 widened to int8 under "q" and bf16 as ml_dtypes
arrays, which unpickling imports (that needs ml_dtypes on the machine).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch

from ..config import UniMoEAudioConfig
from ..ops.quant import QTensor, is_int4, pack_int4
from .bridge import params_from_jax

SERVING_SNAPSHOT = "serving.torch.pkl"
JAX_SERVING_SNAPSHOT = "serving.jax.pkl"


def find_serving_snapshot(model_dir: str):
    """The snapshot file in model_dir (the port's first), or None."""
    for name in (SERVING_SNAPSHOT, JAX_SERVING_SNAPSHOT):
        path = os.path.join(model_dir, name)
        if os.path.isfile(path):
            return path
    return None


def _encode(x):
    """Port params (tensors and QTensors, on any device) → the snapshot's
    numpy-only leaves."""
    if isinstance(x, QTensor):
        return {"__qtensor__": True, "int4": is_int4(x),
                "q_packed" if is_int4(x) else "q": _encode(x.q), "s": _encode(x.s)}
    if isinstance(x, dict):
        return {k: _encode(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_encode(v) for v in x]
    t = x.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return {"__bf16__": t.view(torch.int16).numpy().view(np.uint16)}
    return t.numpy()


def _stack(layers):
    """The per-layer dicts re-stacked into [L, ...] leaves, on the CPU."""
    x = layers[0]
    if isinstance(x, dict):
        return {k: _stack([lp[k] for lp in layers]) for k in x}
    if isinstance(x, QTensor):
        return QTensor(*(_stack(list(parts)) for parts in zip(*layers)))
    return torch.stack([t.cpu() for t in layers])


def save_serving_snapshot(params: Dict, cfg, out_dir: str, *, serving_mode,
                          kv_cache_dtype=None) -> str:
    """Write the port's params (QTensor leaves included), config and modes
    to out_dir/serving.torch.pkl; returns the path."""
    tree = _encode({k: v for k, v in params.items() if k != "layers"})
    tree["layers"] = _encode(_stack(params["layers"]))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, SERVING_SNAPSHOT)
    with open(path, "wb") as f:
        pickle.dump({"config": cfg.to_dict(), "serving_mode": serving_mode,
                     "kv_cache_dtype": kv_cache_dtype, "params": tree}, f, protocol=4)
    return path


def _decode(node):
    """A snapshot tree → the bridge's input: numpy leaves, bf16 tags as bf16
    tensors, QTensor tags as (q, s) named tuples (int4 as the port's packed
    uint8 tensor)."""
    if isinstance(node, dict) and node.get("__qtensor__"):
        s = _decode(node["s"])
        if "q_packed" in node:
            return QTensor(q=torch.from_numpy(node["q_packed"]), s=s)
        q = node["q"]
        if node["int4"]:                                   # the JAX package's widened int4
            q = pack_int4(torch.from_numpy(np.asarray(q).astype(np.int8)))
        return QTensor(q=q, s=s)
    if isinstance(node, dict) and "__bf16__" in node:
        return torch.from_numpy(node["__bf16__"].view(np.int16)).view(torch.bfloat16)
    if isinstance(node, dict):
        return {k: _decode(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode(v) for v in node]
    return node


def load_serving_snapshot(model_dir: str, device="cuda"):
    """(cfg, params on device, serving_mode, kv_cache_dtype) from the port's
    snapshot or the JAX package's in model_dir."""
    path = find_serving_snapshot(model_dir)
    if path is None:
        raise FileNotFoundError(f"no {SERVING_SNAPSHOT} or {JAX_SERVING_SNAPSHOT} in {model_dir}")
    with open(path, "rb") as f:
        blob = pickle.load(f)
    cfg = UniMoEAudioConfig.from_dict(blob["config"])
    params = params_from_jax(_decode(blob["params"]), cfg, device)
    return cfg, params, blob["serving_mode"], blob.get("kv_cache_dtype")
