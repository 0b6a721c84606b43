"""Dense→MoE surgery of the port — counterpart of
`unimoe_audio_tpu/train/surgery.py`: a dense Qwen FFN of intermediate size F
seeds the DCMoE experts of a layer —

  * dynamic expert e takes the contiguous slice [(e·F_d) mod F, + F_d) of
    the dense intermediate dim (rotating offsets);
  * every fixed expert takes the leading slice [0, F_s);
  * moe_copy "single" seeds only expert 0 and draws the others,
    "none" draws them all, N(0, initializer_range²);
  * the router gate is always drawn fresh, N(0, initializer_range²), f32.

The random numbers come from torch.Generators on the weights' device, seeded
from `seed` per layer; they differ from the JAX package's draws, their
distribution does not.  Experts are the port's raw [E, D, F] / [E, F, D]
tensors, the layout its dispatch reads (`kmajor_experts` changes only
quantized experts).
"""

from __future__ import annotations

from typing import Dict, Literal

import torch

from ..config import TextMoEConfig
from ..models.model import fold_seed
from ..ops.quant import kmajor_experts


def dense_ffn_to_experts(dense: Dict[str, torch.Tensor], cfg: TextMoEConfig, *,
                         moe_copy: Literal["all", "single", "none"] = "all",
                         seed: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """One layer's dense FFN {"gate"/"up": [D, F], "down": [F, D]} →
    {"dynamic": {...[E_r, ...]}, "fixed": {...[N_f, ...]}} (`surgery.py:
    30-83`); copied slices keep the dense dtype, drawn experts are f32."""
    F = dense["gate"].shape[1]
    Fd, Fs = cfg.dynamic_intermediate_size, cfg.shared_intermediate_size
    Er, Nf = cfg.mlp_dynamic_expert_num, cfg.mlp_fixed_expert_num
    assert F % Fd == 0 and F % Fs == 0, (
        f"dense intermediate {F} must divide into expert sizes {Fd}/{Fs}")
    D = dense["gate"].shape[0]
    dev = dense["gate"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    std = cfg.initializer_range

    def rand(shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float32, device=dev).mul_(std)

    dynamic = {"gate": [], "up": [], "down": []}
    for e in range(Er):
        if moe_copy == "all" or (moe_copy == "single" and e == 0):
            off = (e * Fd) % F
            dynamic["gate"].append(dense["gate"][:, off:off + Fd])
            dynamic["up"].append(dense["up"][:, off:off + Fd])
            dynamic["down"].append(dense["down"][off:off + Fd, :])
        else:
            dynamic["gate"].append(rand((D, Fd)))
            dynamic["up"].append(rand((D, Fd)))
            dynamic["down"].append(rand((Fd, D)))
    dt = torch.promote_types(dense["gate"].dtype, torch.float32) if moe_copy != "all" \
        else dense["gate"].dtype
    fixed = {"gate": dense["gate"][:, :Fs], "up": dense["up"][:, :Fs],
             "down": dense["down"][:Fs, :]}
    return {
        "dynamic": {k: torch.stack([t.to(dt) for t in v]) for k, v in dynamic.items()},
        "fixed": {k: v[None].expand(Nf, *v.shape).clone() for k, v in fixed.items()},
    }


def moeify_dense_params(dense_params: Dict, cfg: TextMoEConfig, *,
                        moe_copy: Literal["all", "single", "none"] = "all", seed: int = 0,
                        dtype=torch.bfloat16) -> Dict:
    """Whole-model surgery (`surgery.py:86-128`): the port's dense param
    dict (each layer with "mlp" {"gate"/"up": [D, F], "down": [F, D]} where
    a DCMoE model has "moe") → a DCMoE param dict.  A new tree: every leaf a
    fresh tensor in dtype, except the router gate, which stays f32; the
    input is not changed.  Layer l's experts draw from fold_seed(seed, l),
    its gate from fold_seed(fold_seed(seed, L), l)."""
    L = cfg.num_hidden_layers
    D = cfg.hidden_size

    def cast(t):
        return t.to(dtype, copy=True)

    def cast_tree(t):
        if isinstance(t, dict):
            return {k: cast_tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [cast_tree(v) for v in t]
        return cast(t)

    out = cast_tree({k: v for k, v in dense_params.items() if k != "layers"})
    layers = []
    for l, lp in enumerate(dense_params["layers"]):
        experts = dense_ffn_to_experts(lp["mlp"], cfg, moe_copy=moe_copy,
                                       seed=fold_seed(seed, l))
        dev = lp["mlp"]["gate"].device
        gen = torch.Generator(device=dev)
        gen.manual_seed(fold_seed(fold_seed(seed, L), l))
        gate = torch.randn(D, cfg.num_experts, generator=gen, dtype=torch.float32,
                           device=dev).mul_(cfg.initializer_range)
        new = cast_tree({k: v for k, v in lp.items() if k != "mlp"})
        new["moe"] = {"gate": gate, "dynamic": cast_tree(experts["dynamic"]),
                      "fixed": cast_tree(experts["fixed"])}
        layers.append(new)
    out["layers"] = layers
    return kmajor_experts(out)
