"""Bridge between the JAX package's parameter pytrees and the port's tensors.

Input is the pytree after `jax.tree.map(np.asarray, params)`: nested dicts
and lists of numpy arrays, laid out as in `unimoe_audio_tpu/models/model.py`
(layer-stacked `[L, ...]` leaves) and `unimoe_audio_tpu/codec/dac.py`.
The port reads the same layouts, so the bridge copies; the layer stack is
un-stacked into one dict per layer (and re-stacked by `params_to_numpy`).
Quantized (`QTensor`) leaves come with the quantization slice and raise
here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import UniMoEAudioConfig


def _is_qtensor(x: Any) -> bool:
    return isinstance(x, tuple) and set(getattr(x, "_fields", ())) == {"q", "s"}


def to_torch(tree: Any, device, dtype: Optional[torch.dtype], path: str = ""):
    """Nested dicts / lists of numpy arrays → the same nesting of tensors
    (copies) on `device`; floating leaves cast to dtype unless it is None."""
    if _is_qtensor(tree):
        raise NotImplementedError(
            f"quantized leaf (QTensor) at {path or '<root>'}: quantized weights come "
            "with the quantization slice; bridge the unquantized params")
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device, dtype, f"{path}[{i}]") for i, v in enumerate(tree)]
    t = torch.tensor(np.asarray(tree), device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def _unstack(tree: Any, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def params_from_jax(tree: Dict, cfg: UniMoEAudioConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict:
    """JAX model params (numpy leaves) → the port's param dict, with
    `layers` as a list of per-layer dicts.  dtype=None keeps each leaf's
    dtype; otherwise floating leaves are cast to dtype."""
    if "vision" in tree or "peft" in tree:
        raise NotImplementedError("vision and PEFT params come with later slices")
    out = to_torch({k: v for k, v in tree.items() if k != "layers"}, device, dtype)
    stacked = to_torch(tree["layers"], device, dtype, "/layers")
    L = stacked["input_layernorm"].shape[0]
    if L != cfg.text_config.num_hidden_layers:
        raise ValueError(f"layer stack holds {L} layers, config says "
                         f"{cfg.text_config.num_hidden_layers}")
    out["layers"] = [_unstack(stacked, i) for i in range(L)]
    return out


def to_numpy(tree: Any):
    """Nested dicts / lists of tensors → the same nesting of numpy arrays
    (bf16 leaves as f32: numpy has no bf16)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([lp[k] for lp in layers]) for k in layers[0]}
    return np.stack(layers)


def params_to_numpy(params: Dict) -> Dict:
    """The port's param dict → the JAX package's layout with numpy leaves
    (per-layer dicts re-stacked into `[L, ...]` leaves), the inverse of
    `params_from_jax`."""
    out = to_numpy({k: v for k, v in params.items() if k != "layers"})
    out["layers"] = _stack([to_numpy(lp) for lp in params["layers"]])
    return out


def dac_params_from_jax(tree: Dict, device="cuda", dtype: Optional[torch.dtype] = None) -> Dict:
    """JAX DAC params (numpy leaves) → the port's DAC param dict (decoder
    and quantizer; the encoder is dropped until the TTS slice)."""
    return to_torch({k: tree[k] for k in ("quantizer", "decoder")}, device, dtype)
