"""UniMoE-Audio model of the port: the MoE decoder stack plus the codec
embeddings and head — counterpart of `unimoe_audio_tpu/models/model.py`.

Parameters are plain dicts of tensors; the JAX package's layer-stacked
`[L, ...]` leaves are un-stacked into one dict per layer, and the stack runs
as a Python loop over them:
  {
    "embed_tokens": [V, D],
    "layers": [ {"input_layernorm": [D], "post_attention_layernorm": [D],
                 "attn": {"q_proj": {"w": [D, H·Dh], "b": [H·Dh]}, ...},
                 "moe": {"gate": [D, E], "dynamic": {...}, "fixed": {...}}},
                ... L entries ],
    "norm": [D],
    "lm_head": [D, V],
    "codec_embed": [C, Vc, D],
    "codec_head": [D, C·Vc],
  }
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..config import TextMoEConfig, UniMoEAudioConfig
from ..moe.block import dcmoe_block, init_dcmoe_params
from ..ops.quant import matmul
from .layers import KVCache, attention, compute_mrope, init_attention_params, rms_norm


class TextModelOutput(NamedTuple):
    last_hidden_state: torch.Tensor           # [B, T, D]
    kv_cache: Optional[KVCache]
    aux_loss: torch.Tensor                    # [L]
    router_top_k: torch.Tensor                # [L, S]


def text_model_forward(
    params: Dict,
    inputs_embeds: torch.Tensor,          # [B, T, D]
    position_ids: torch.Tensor,           # [3, B, T]
    cfg: TextMoEConfig,
    *,
    kv_cache: Optional[KVCache] = None,
    cache_position: Optional[int] = None,
    kv_valid_mask: Optional[torch.Tensor] = None,
    padding_token_mask: Optional[torch.Tensor] = None,
    use_flash: Optional[bool] = None,
) -> TextModelOutput:
    """Pre-norm attention + pre-norm DCMoE per layer with residuals, then
    the final RMSNorm (`model.py:55-266`, inference path).

    With a cache and one query position (decode_emit) each layer attends
    over the stale cache plus its own fresh k/v; the fresh k/v are committed
    to the cache in place once that layer's attention is done, which is
    what the JAX package's batched commit after the layer scan amounts to
    (the mask keeps the current slot out of every layer's read).
    """
    if cfg.has_sliding_layers:
        raise NotImplementedError("sliding-window layers are not ported yet")
    B, T, _ = inputs_embeds.shape
    cos, sin = compute_mrope(position_ids, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
    use_cache = kv_cache is not None
    decode_emit = (use_cache and T == 1 and cache_position is not None
                   and kv_valid_mask is not None)
    layer_mask = kv_valid_mask
    if decode_emit:
        slots = torch.arange(kv_cache.k.shape[1], device=kv_valid_mask.device)
        layer_mask = kv_valid_mask * (slots[None, :] != cache_position).to(kv_valid_mask.dtype)

    h = inputs_embeds
    aux, top_k = [], []
    for i, lp in enumerate(params["layers"]):
        residual = h
        hn = rms_norm(h, lp["input_layernorm"], cfg.rms_norm_eps)
        attn_out, new_kv = attention(
            lp["attn"], hn, cos, sin, cfg,
            cache_kv=(kv_cache.k[i], kv_cache.v[i]) if use_cache else None,
            cache_position=cache_position,
            kv_valid_mask=layer_mask,
            use_flash=use_flash,
            decode_emit=decode_emit,
        )
        if decode_emit:
            # In-place commit of this step's k/v (one [B, 1, KV, Dh] slot).
            kv_cache.k[i, cache_position] = new_kv[0][:, 0].to(kv_cache.k.dtype)
            kv_cache.v[i, cache_position] = new_kv[1][:, 0].to(kv_cache.v.dtype)
        h = residual + attn_out
        residual = h
        hn = rms_norm(h, lp["post_attention_layernorm"], cfg.rms_norm_eps)
        moe_out = dcmoe_block(lp["moe"], hn, cfg, padding_token_mask=padding_token_mask)
        h = residual + moe_out.hidden_states
        aux.append(moe_out.aux_loss)
        top_k.append(moe_out.router_top_k)
    h = rms_norm(h, params["norm"], cfg.rms_norm_eps)
    return TextModelOutput(
        last_hidden_state=h, kv_cache=kv_cache,
        aux_loss=torch.stack(aux), router_top_k=torch.stack(top_k))


def codec_embedding(params: Dict, codec_input_ids: torch.Tensor) -> torch.Tensor:
    """Sum of per-channel codec embeddings; codec_input_ids [..., C]."""
    tables = params["codec_embed"]                                # [C, Vc, D]
    C = tables.shape[0]
    embs = tables[torch.arange(C, device=tables.device), codec_input_ids.long()]  # [..., C, D]
    return embs.sum(dim=-2)


def calculate_input_embedding(params: Dict, input_ids: torch.Tensor,
                              codec_input_ids: Optional[torch.Tensor],
                              placeholder_id: int) -> torch.Tensor:
    """Text embeddings with codec embeddings at placeholder slots
    (codec_input_ids aligned [B, T, C], pad positions arbitrary)."""
    emb = params["embed_tokens"][input_ids.long()]
    if codec_input_ids is not None:
        cemb = codec_embedding(params, codec_input_ids).to(emb.dtype)
        mask = (input_ids == placeholder_id)[..., None]
        emb = torch.where(mask, cemb, emb)
    return emb


def codec_logits_from_hidden(params: Dict, hidden: torch.Tensor,
                             cfg: UniMoEAudioConfig) -> torch.Tensor:
    """[B, T, D] → [B, T, C, Vc] codec logits (fp32)."""
    flat = matmul(hidden, params["codec_head"]).float()
    B, T = hidden.shape[:2]
    return flat.reshape(B, T, cfg.codec_channels, cfg.codec_embed_size)


def init_model_params(cfg: UniMoEAudioConfig, *, seed: int = 0, dtype=torch.bfloat16,
                      device="cuda") -> Dict:
    """Random weights made directly on `device`, tensor by tensor in the
    working dtype (the DCMoE router stays f32, as in the JAX init), from a
    seeded torch.Generator on that device.  The layout and scales follow
    `init_model_params` in the JAX package; the numbers differ (another
    generator)."""
    tc = cfg.text_config
    Dm, V = tc.hidden_size, tc.vocab_size
    C, Vc = cfg.codec_channels, cfg.codec_embed_size
    std = tc.initializer_range
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def nrm(shape, scale):
        return torch.randn(*shape, generator=gen, dtype=dtype, device=device).mul_(scale)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    layers = [{
        "input_layernorm": ones(Dm),
        "post_attention_layernorm": ones(Dm),
        "attn": init_attention_params(gen, tc, dtype=dtype, device=device),
        "moe": init_dcmoe_params(gen, tc, dtype=dtype, device=device),
    } for _ in range(tc.num_hidden_layers)]
    return {
        "embed_tokens": nrm((V, Dm), std),
        "layers": layers,
        "norm": ones(Dm),
        "lm_head": nrm((Dm, V), Dm ** -0.5),
        "codec_embed": nrm((C, Vc, Dm), std),
        "codec_head": nrm((Dm, C * Vc), Dm ** -0.5),
    }
