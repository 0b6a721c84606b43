"""Expert compute for DCMoE, dense dispatch — counterpart of
`unimoe_audio_tpu/moe/dispatch.py:46-128` (bf16 path).  Packed, a8, ep and
gmm dispatch come with later slices.

Stacked expert layout as in the JAX package:
  params = {"gate": [E, D, F], "up": [E, D, F], "down": [E, F, D]}
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..ops.quant import expert_einsum, wshape


def swiglu_expert_ffn(x_ecd: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Batched per-expert SwiGLU FFN: [E, C, D] → [E, C, D]."""
    g = expert_einsum("ecd,edf->ecf", x_ecd, params["gate"])
    u = expert_einsum("ecd,edf->ecf", x_ecd, params["up"])
    return expert_einsum("ecf,efd->ecd", F.silu(g) * u, params["down"])


def moe_ffn_dense(hidden: torch.Tensor, expert_mask: torch.Tensor,
                  router_weight: torch.Tensor, params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Every expert on every token, combined by weight:
    out[s] = Σ_e (w[s, e]·mask[s, e]) · FFN_e(hidden[s])."""
    w = router_weight * expert_mask.to(router_weight.dtype)       # [S, E]
    x = hidden[None].expand(wshape(params["gate"])[0], *hidden.shape)
    y = swiglu_expert_ffn(x, params)                              # [E, S, D]
    return (y * w.t()[:, :, None].to(y.dtype)).sum(dim=0)
