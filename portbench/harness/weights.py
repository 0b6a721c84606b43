"""Random weights of a UniMoE-Audio decoder, made by the benchmark from the
run's seed, in the port's parameter layout (`unimoe_audio_torch.models.model`):

  {"embed_tokens": [V, D],
   "layers": [{"input_layernorm": [D], "post_attention_layernorm": [D],
               "attn": {"q_proj": {"w", "b"}, "k_proj": {"w", "b"},
                        "v_proj": {"w", "b"}, "o_proj": {"w"}},
               "moe": {"gate": [D, E] f32, "dynamic": {"gate", "up", "down"},
                       "fixed": {"gate", "up", "down"}}}, ... L],
   "norm": [D], "lm_head": [D, V], "codec_embed": [C, Vc, D],
   "codec_head": [D, C·Vc]}

Each kind of leaf is one `torch.randn` on the device, stacked over the
layers ([L, ...]), from a generator of its own seeded with (seed, kind), so
that one kind can be made again alone: the training check rebuilds the
starting weights kind by kind, and the reference rebuilds every weight
after the program is freed.  A layer's leaf is a view of its kind's
stack; a program that replaces every layer's leaf (quantization) frees the
stack.  Scales follow the published initialisation (normal with
`initializer_range` for embeddings and the router, fan-in scaled
projections, unit norms); the attention biases are drawn with
`initializer_range` (an assumption: random weights have no published
biases, and zero biases would leave their path untested).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import torch

# (kind, layer-stacked?) in a fixed order: the index is part of each
# kind's generator seed, so the order is part of the yardstick.
KINDS = (
    "input_layernorm", "post_attention_layernorm",
    "q_w", "q_b", "k_w", "k_b", "v_w", "v_b", "o_w",
    "router", "dyn_gate", "dyn_up", "dyn_down", "fix_gate", "fix_up", "fix_down",
    "embed_tokens", "norm", "lm_head", "codec_embed", "codec_head",
)
OUTER = ("embed_tokens", "norm", "lm_head", "codec_embed", "codec_head")


def kind_seed(seed: int, kind: str) -> int:
    """The generator seed of one kind: (seed, kind index) mixed into 63 bits."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + (KINDS.index(kind) + 1) * 0xBF58476D1CE4E5B9)
    x ^= x >> 31
    return x % (1 << 63)


def kind_spec(cfg, kind: str) -> Tuple[Tuple[int, ...], float, torch.dtype]:
    """(shape, scale, dtype) of one kind; scale 0 marks a unit tensor."""
    tc = cfg.text_config
    L, D = tc.num_hidden_layers, tc.hidden_size
    H, KV, Dh = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    Er, Nf = tc.mlp_dynamic_expert_num, tc.mlp_fixed_expert_num
    Fd, Fs = tc.dynamic_intermediate_size, tc.shared_intermediate_size
    V, C, Vc = tc.vocab_size, cfg.codec_channels, cfg.codec_embed_size
    std = tc.initializer_range
    bf, f32 = torch.bfloat16, torch.float32
    return {
        "input_layernorm": ((L, D), 0.0, bf),
        "post_attention_layernorm": ((L, D), 0.0, bf),
        "q_w": ((L, D, H * Dh), D ** -0.5, bf), "q_b": ((L, H * Dh), std, bf),
        "k_w": ((L, D, KV * Dh), D ** -0.5, bf), "k_b": ((L, KV * Dh), std, bf),
        "v_w": ((L, D, KV * Dh), D ** -0.5, bf), "v_b": ((L, KV * Dh), std, bf),
        "o_w": ((L, H * Dh, D), (H * Dh) ** -0.5, bf),
        "router": ((L, D, tc.num_experts), std, f32),
        "dyn_gate": ((L, Er, D, Fd), D ** -0.5, bf), "dyn_up": ((L, Er, D, Fd), D ** -0.5, bf),
        "dyn_down": ((L, Er, Fd, D), Fd ** -0.5, bf),
        "fix_gate": ((L, Nf, D, Fs), D ** -0.5, bf), "fix_up": ((L, Nf, D, Fs), D ** -0.5, bf),
        "fix_down": ((L, Nf, Fs, D), Fs ** -0.5, bf),
        "embed_tokens": ((V, D), std, bf), "norm": ((D,), 0.0, bf),
        "lm_head": ((D, V), D ** -0.5, bf), "codec_embed": ((C, Vc, D), std, bf),
        "codec_head": ((D, C * Vc), D ** -0.5, bf),
    }[kind]


def make_kind(cfg, seed: int, kind: str, device) -> torch.Tensor:
    """One kind's tensor (stacked over the layers where it is per layer)."""
    shape, scale, dtype = kind_spec(cfg, kind)
    if scale == 0.0:
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(kind_seed(seed, kind))
    return torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(scale)


def _layer(k: Dict[str, torch.Tensor], i: int) -> Dict:
    return {
        "input_layernorm": k["input_layernorm"][i],
        "post_attention_layernorm": k["post_attention_layernorm"][i],
        "attn": {"q_proj": {"w": k["q_w"][i], "b": k["q_b"][i]},
                 "k_proj": {"w": k["k_w"][i], "b": k["k_b"][i]},
                 "v_proj": {"w": k["v_w"][i], "b": k["v_b"][i]},
                 "o_proj": {"w": k["o_w"][i]}},
        "moe": {"gate": k["router"][i],
                "dynamic": {"gate": k["dyn_gate"][i], "up": k["dyn_up"][i],
                            "down": k["dyn_down"][i]},
                "fixed": {"gate": k["fix_gate"][i], "up": k["fix_up"][i],
                          "down": k["fix_down"][i]}},
    }


def make_params(cfg, seed: int, device, *, outer: Tuple[str, ...] = OUTER) -> Dict:
    """The whole parameter tree from the seed; `outer` limits the weights
    outside the layer stack to those named."""
    k = {kind: make_kind(cfg, seed, kind, device) for kind in KINDS
         if kind not in OUTER or kind in outer}
    params = {"embed_tokens": k["embed_tokens"]} if "embed_tokens" in k else {}
    params["layers"] = [_layer(k, i) for i in range(cfg.text_config.num_hidden_layers)]
    for name in OUTER[1:]:
        if name in k:
            params[name] = k[name]
    return params


# Path of each kind inside a layer dict, for `leaf_kind`.
_LAYER_PATHS = {
    ("input_layernorm",): "input_layernorm",
    ("post_attention_layernorm",): "post_attention_layernorm",
    ("attn", "q_proj", "w"): "q_w", ("attn", "q_proj", "b"): "q_b",
    ("attn", "k_proj", "w"): "k_w", ("attn", "k_proj", "b"): "k_b",
    ("attn", "v_proj", "w"): "v_w", ("attn", "v_proj", "b"): "v_b",
    ("attn", "o_proj", "w"): "o_w",
    ("moe", "gate"): "router",
    ("moe", "dynamic", "gate"): "dyn_gate", ("moe", "dynamic", "up"): "dyn_up",
    ("moe", "dynamic", "down"): "dyn_down",
    ("moe", "fixed", "gate"): "fix_gate", ("moe", "fixed", "up"): "fix_up",
    ("moe", "fixed", "down"): "fix_down",
}


def walk(tree, path=()) -> Iterator[Tuple[tuple, torch.Tensor]]:
    """(path, leaf) in the order of the program's `named_leaves` (dicts in
    insertion order, lists in order), with list indices kept in the path."""
    if isinstance(tree, dict):
        for key, v in tree.items():
            yield from walk(v, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (i,))
    else:
        yield path, tree


def leaf_name(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def leaf_kind(path: tuple) -> Tuple[str, int]:
    """(kind, layer index or -1) of a leaf path of `make_params`' tree."""
    if path and path[0] == "layers":
        return _LAYER_PATHS[tuple(path[2:])], path[1]
    return path[0], -1


def leaf_from_kinds(path: tuple, stacks: Dict[str, torch.Tensor]) -> torch.Tensor:
    kind, i = leaf_kind(path)
    return stacks[kind] if i < 0 else stacks[kind][i]


def kinds_in(paths: List[tuple]) -> List[str]:
    """The kinds the leaves at `paths` come from, in `KINDS` order."""
    used = {leaf_kind(p)[0] for p in paths}
    return [k for k in KINDS if k in used]
