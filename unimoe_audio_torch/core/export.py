"""Export — counterpart of `unimoe_audio_tpu/core/export.py`: the HF-layout
checkpoint (`export_hf_checkpoint`, the inverse of
`core/convert.convert_model_state_dict`), and serving snapshots.

The HF layout: the reference's module names (`language_model.layers.{l}...`,
`mlp.dynamic_real_moe.deepspeed_moe.experts.deepspeed_experts.{e}`,
`mlp.fixed_real_moe.{e}`), projection weights [out, in], written as
`model.safetensors` by the port's own writer (`core/convert.write_safetensors`)
and `config.json`.

Serving snapshots: the quantized serving params, config and modes on disk,
so that a restart skips the quantization pass (and for "int4-gptq" the
self-calibration) (`export.py:84-149`).

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
from ..ops.quant import QTensor, dequantize, is_int4, pack_int4
from .bridge import params_from_jax

def model_params_to_state_dict(params: Dict, cfg, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The port's param tree → the HF state dict {name: CPU tensor in
    dtype}, projection weights transposed to [out, in] as contiguous copies
    (`export.py:19-73`).  QTensor leaves are dequantized.  The vision tower
    is not exported, as in the JAX package."""
    tc = cfg.text_config
    sd: Dict[str, torch.Tensor] = {}

    def put(name, t, transpose=False):
        if isinstance(t, QTensor):
            t = dequantize(t)
        t = t.detach().to("cpu", dtype)
        sd[name] = (t.t() if transpose else t).contiguous()

    put("language_model.embed_tokens.weight", params["embed_tokens"])
    put("language_model.norm.weight", params["norm"])
    put("lm_head.weight", params["lm_head"], transpose=True)
    for c in range(cfg.codec_channels):
        put(f"codec_embed_tokens.{c}.weight", params["codec_embed"][c])
    put("codec_head.weight", params["codec_head"], transpose=True)
    for l, lp in enumerate(params["layers"]):
        p = f"language_model.layers.{l}"
        put(f"{p}.input_layernorm.weight", lp["input_layernorm"])
        put(f"{p}.post_attention_layernorm.weight", lp["post_attention_layernorm"])
        for proj in ("q_proj", "k_proj", "v_proj"):
            put(f"{p}.self_attn.{proj}.weight", lp["attn"][proj]["w"], transpose=True)
            put(f"{p}.self_attn.{proj}.bias", lp["attn"][proj]["b"])
        put(f"{p}.self_attn.o_proj.weight", lp["attn"]["o_proj"]["w"], transpose=True)
        put(f"{p}.mlp.gate.weight", lp["moe"]["gate"], transpose=True)
        for group, base, n in (
                ("dynamic", f"{p}.mlp.dynamic_real_moe.deepspeed_moe.experts.deepspeed_experts",
                 tc.mlp_dynamic_expert_num),
                ("fixed", f"{p}.mlp.fixed_real_moe", tc.mlp_fixed_expert_num)):
            w = {k: dequantize(v) if isinstance(v, QTensor) else v
                 for k, v in lp["moe"][group].items()}
            for e in range(n):
                for k in ("gate", "up", "down"):
                    put(f"{base}.{e}.{k}_proj.weight", w[k][e], transpose=True)
    return sd


def export_hf_checkpoint(params: Dict, cfg, out_dir: str, *, dtype="float32") -> int:
    """Write config.json and model.safetensors in the reference's layout
    (`export.py:76-84`), weights in dtype (a name or a torch dtype: float32,
    bfloat16, float16); returns the bytes of model.safetensors.  Both
    packages' `UniMoEAudio` load the directory."""
    from .convert import write_safetensors

    os.makedirs(out_dir, exist_ok=True)
    t_dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    n = write_safetensors(os.path.join(out_dir, "model.safetensors"),
                          model_params_to_state_dict(params, cfg, t_dtype))
    cfg.save_json(os.path.join(out_dir, "config.json"))
    return n


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
