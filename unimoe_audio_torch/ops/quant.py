"""Weight matmuls of the port — the plain-tensor branches of
`unimoe_audio_tpu/ops/quant.py:55-145`.

The quantized (`QTensor`) weights of the serving modes come with the
quantization slice; until then every weight here is a plain tensor in the
JAX package's `[..., D, F]` layout (contraction dim at axis -2).
"""

from __future__ import annotations

from typing import Dict

import torch


def _plain(w) -> torch.Tensor:
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(
            f"quantized weights ({type(w).__name__}) come with the quantization "
            "slice; this port takes plain tensors only")
    return w


def wshape(w) -> torch.Size:
    """Shape of a weight."""
    return _plain(w).shape


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a `[..., D, F]` weight, in x's dtype."""
    return x @ _plain(w).to(x.dtype)


def proj_matmul(x: torch.Tensor, proj: Dict) -> torch.Tensor:
    """x @ proj["w"] (LoRA deltas come with the PEFT slice)."""
    if "lora_a" in proj:
        raise NotImplementedError("LoRA projections come with the PEFT slice")
    return matmul(x, proj["w"])


def expert_einsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """einsum('ecd,edf->ecf'-style) over stacked expert weights."""
    return torch.einsum(spec, x, _plain(w).to(x.dtype))
