"""Bridge between the JAX package's parameter pytrees and the port's tensors.

Input is the pytree after `jax.tree.map(np.asarray, params)`: nested dicts
and lists of numpy arrays, laid out as in `unimoe_audio_tpu/models/model.py`
(layer-stacked `[L, ...]` leaves) and `unimoe_audio_tpu/codec/dac.py`.
The port reads the same layouts, so the bridge copies; the layer stack is
un-stacked into one dict per layer (and re-stacked by `params_to_numpy`).

Quantized leaves (the JAX package's `QTensor(q, s)` named tuples) become
the port's `ops.quant.QTensor`: int8 q as it is; JAX int4 q (which
`np.asarray` gives as `ml_dtypes.int4`, values in [-8, 7]) widened and
packed two nibbles a byte; s as it is (f32, or bf16 for int4); expert q
K-major.  `params_to_numpy` gives the port's QTensor back with numpy
leaves, q as int8 values (int4 unpacked) and s in f32.  bf16 numpy arrays
(ml_dtypes) are read through their bits, so the port itself never imports
ml_dtypes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import UniMoEAudioConfig
from ..ops.quant import QTensor, kmajor_experts, pack_int4, qvalues


def _is_qtensor(x: Any) -> bool:
    return isinstance(x, tuple) and set(getattr(x, "_fields", ())) == {"q", "s"}


def numpy_to_tensor(a, device) -> torch.Tensor:
    """A numpy array (bf16 from ml_dtypes included, read through its bits)
    → a tensor on device (a copy); a tensor is moved to device."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def _qtensor_to_torch(x, device, path: str) -> QTensor:
    if isinstance(x.q, torch.Tensor):                 # already the port's (a snapshot's)
        return QTensor(q=x.q.to(device), s=numpy_to_tensor(x.s, device))
    q, s = np.asarray(x.q), np.asarray(x.s)
    if q.ndim < 2 or s.ndim != q.ndim or s.shape[-1] != q.shape[-1] or \
            q.shape[-2] % s.shape[-2] or s.shape[:-2] != q.shape[:-2]:
        raise ValueError(f"QTensor at {path or '<root>'}: scales {s.shape} do not fit q "
                         f"{q.shape} ([..., Dg, F] with Dg dividing D)")
    if q.dtype.name == "int4":
        return QTensor(q=pack_int4(torch.tensor(q.astype(np.int8), device=device)),
                       s=numpy_to_tensor(s, device))
    return QTensor(q=torch.tensor(q, device=device), s=numpy_to_tensor(s, device))


def to_torch(tree: Any, device, dtype: Optional[torch.dtype], path: str = ""):
    """Nested dicts / lists of numpy arrays → the same nesting of tensors
    (copies) on `device`; floating leaves cast to dtype unless it is None.
    QTensor leaves keep their own dtypes."""
    if _is_qtensor(tree):
        return _qtensor_to_torch(tree, device, path)
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype, f"{path}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v, device, dtype, f"{path}[{i}]") for i, v in enumerate(tree)]
    t = numpy_to_tensor(tree, device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def _unstack(tree: Any, i: int):
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(q=tree.q[i], s=tree.s[i])
    return tree[i]


def params_from_jax(tree: Dict, cfg: UniMoEAudioConfig, device="cuda",
                    dtype: Optional[torch.dtype] = None) -> Dict:
    """JAX model params (numpy leaves) → the port's param dict, with
    `layers` as a list of per-layer dicts.  dtype=None keeps each leaf's
    dtype; otherwise floating leaves are cast to dtype.  The vision tower
    (`"vision"`, its blocks a list in both packages) is copied as it is,
    QTensor leaves included.  So are a dense model's `layers.mlp`, LoRA
    factors (`lora_a [L, din, r]`, `lora_b [L, r, dout]`, `lora_scale [L]`,
    one layer's slice per dict) and the PEFT adapters (`"peft"`)."""
    out = to_torch({k: v for k, v in tree.items() if k != "layers"}, device, dtype)
    stacked = to_torch(tree["layers"], device, dtype, "/layers")
    L = stacked["input_layernorm"].shape[0]
    if L != cfg.text_config.num_hidden_layers:
        raise ValueError(f"layer stack holds {L} layers, config says "
                         f"{cfg.text_config.num_hidden_layers}")
    out["layers"] = [_unstack(stacked, i) for i in range(L)]
    return kmajor_experts(out)


def to_numpy(tree: Any):
    """Nested dicts / lists of tensors → the same nesting of numpy arrays
    (bf16 leaves as f32: numpy has no bf16); a QTensor → QTensor(q int8
    values, s f32) of numpy arrays."""
    if isinstance(tree, QTensor):
        return QTensor(q=to_numpy(qvalues(tree).contiguous()), s=to_numpy(tree.s.float()))
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _stack(layers):
    if isinstance(layers[0], dict):
        return {k: _stack([lp[k] for lp in layers]) for k in layers[0]}
    if isinstance(layers[0], QTensor):
        return QTensor(q=np.stack([t.q for t in layers]), s=np.stack([t.s for t in layers]))
    return np.stack(layers)


def params_to_numpy(params: Dict) -> Dict:
    """The port's param dict → the JAX package's layout with numpy leaves
    (per-layer dicts re-stacked into `[L, ...]` leaves), the inverse of
    `params_from_jax`."""
    out = to_numpy({k: v for k, v in params.items() if k != "layers"})
    out["layers"] = _stack([to_numpy(lp) for lp in params["layers"]])
    return out


def dac_params_from_jax(tree: Dict, device="cuda", dtype: Optional[torch.dtype] = None) -> Dict:
    """JAX DAC params (numpy leaves) → the port's DAC param dict: encoder,
    quantizer (in- and out-projections, codebooks) and decoder."""
    return to_torch({k: tree[k] for k in ("encoder", "quantizer", "decoder")}, device, dtype)
