"""Model FLOPs of the UniMoE-Audio decoder from its shapes: 2 per
multiply-add of every product the model needs, whatever the program
computes on top (dense dispatch computing every expert, masked cache
slots, remat's second forward).  Routed experts count at `real_k`
experts per token: the routed experts that compute (the null expert and
unselected experts excluded)."""


def layer_forward_per_token(tc, real_k: float, keys: float) -> float:
    """One token through one decoder layer that attends `keys` keys."""
    D, H, KV, Dh = tc.hidden_size, tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    proj = 2 * D * (H * Dh + 2 * KV * Dh) + 2 * H * Dh * D
    attn = 4 * H * Dh * keys
    router = 2 * D * tc.num_experts
    routed = real_k * 3 * 2 * D * tc.dynamic_intermediate_size
    fixed = tc.mlp_fixed_expert_num * 3 * 2 * D * tc.shared_intermediate_size
    return proj + attn + router + routed + fixed


def codec_head_per_token(cfg) -> float:
    return 2 * cfg.text_config.hidden_size * cfg.codec_channels * cfg.codec_embed_size


def train_step(cfg, B: int, T: int, real_k: float) -> float:
    """Forward and backward (x3) of B causal rows of T codec positions."""
    tc = cfg.text_config
    mean_keys = (T + 1) / 2
    fwd = B * T * (tc.num_hidden_layers * layer_forward_per_token(tc, real_k, mean_keys)
                   + codec_head_per_token(cfg))
    return 3 * fwd


def decode_row(cfg, real_k: float, keys: float) -> float:
    """One decode step of one CFG row attending `keys` keys, with its head."""
    tc = cfg.text_config
    return tc.num_hidden_layers * layer_forward_per_token(tc, real_k, keys) + \
        codec_head_per_token(cfg)


def prefill(cfg, n_tokens: int, real_k: float) -> float:
    """A causal prefill of n_tokens attended tokens (no head)."""
    tc = cfg.text_config
    return n_tokens * tc.num_hidden_layers * layer_forward_per_token(tc, real_k,
                                                                     (n_tokens + 1) / 2)
