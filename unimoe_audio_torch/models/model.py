"""UniMoE-Audio model of the port: the MoE decoder stack plus the codec
embeddings and head, for generation and training — counterpart of
`unimoe_audio_tpu/models/model.py`.

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
    "vision": the vision tower (`models/vision.py`), when present,
  }
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import TextMoEConfig, UniMoEAudioConfig
from ..moe.block import dcmoe_block, init_dcmoe_params
from ..ops.quant import matmul
from ..parallel.comm import all_reduce, copy_to, gather_dim, group_size, reduce_from, scatter_dim
from ..parallel.mesh import batch_group, tp_group
from ..utils import profiling
from .layers import (KVCache, attention, compute_mrope, init_attention_params, quantize_kv,
                     rms_norm, write_slots)
from .vision import init_vision_params, vision_forward


class TextModelOutput(NamedTuple):
    last_hidden_state: torch.Tensor           # [B, T, D]
    kv_cache: Optional[KVCache]
    aux_loss: torch.Tensor                    # [L]
    router_top_k: torch.Tensor                # [L, S]
    moe_inputs: Optional[torch.Tensor] = None  # [L, B, T, D] f32 (output_moe_inputs)


def fold_seed(seed: int, n: int) -> int:
    """A seed derived from (seed, n) — the port's `jax.random.fold_in`: the
    training step folds its step count into the trainer's seed, and the
    layer stack gives each layer `fold_seed(seed, layer)`, as the JAX
    package splits its rng key into one key per layer (`model.py:108-110`)."""
    return int(np.random.SeedSequence([seed, n]).generate_state(1, np.uint64)[0] >> 1)


def sliding_flags(cfg: TextMoEConfig, n_layers: int) -> List[bool]:
    """Whether each of the first n_layers layers attends through a sliding
    window (`layer_types` "sliding_attention", with `use_sliding_window` and
    a `sliding_window`; `model.py:113-122`)."""
    if not cfg.has_sliding_layers:
        return [False] * n_layers
    return [t == "sliding_attention" for t in cfg.layer_types][:n_layers]


class LayerOutput(NamedTuple):
    hidden: torch.Tensor                      # [B, T, D]
    aux_loss: torch.Tensor                    # scalar
    router_top_k: torch.Tensor                # [S]
    kv: Optional[tuple]                       # attention's cache / fresh (k, v)
    moe_input: torch.Tensor                   # the DCMoE block's input [B, T, D]


def layer_apply(lp: Dict, h: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                cfg: TextMoEConfig, *, kv_valid_mask: Optional[torch.Tensor] = None,
                padding_token_mask: Optional[torch.Tensor] = None,
                aux_balance_weight: Optional[torch.Tensor] = None, training: bool = False,
                seed: Optional[int] = None, use_flash: Optional[bool] = None,
                dispatch_mode: str = "dense", capacity: Optional[int] = None,
                is_sliding: bool = False, prefix_kv=None, cache_kv=None, cache_scales=None,
                cache_position=None,
                decode_emit: bool = False, ring=None, seq_group=None) -> LayerOutput:
    """One decoder layer: pre-norm attention and pre-norm DCMoE, each with
    its residual (`model.py:171-213`).  `seed` is this layer's jitter seed.
    `text_model_forward` runs its layers through it, and the stream trainer
    (`train/stream.py`) one layer at a time.  ring: attention's ring group
    (`models/layers.attention`).  seq_group: the model group of sequence
    parallelism (`text_model_forward(seq_axis=...)`): h holds this rank's
    rows of T, the norms run on them (their weights through `copy_to`, so
    their gradients sum over the group), the normed rows are gathered over
    T before attention and before the DCMoE block, and both give back this
    rank's rows."""
    sp = seq_group is not None

    def norm(x, w):
        return gather_dim(rms_norm(x, copy_to(w, seq_group), cfg.rms_norm_eps), seq_group, 1)

    residual = h
    hn = norm(h, lp["input_layernorm"])
    with profiling.span("model.attention"):
        attn_out, kv = attention(
            lp["attn"], hn, cos, sin, cfg, cache_kv=cache_kv, cache_scales=cache_scales,
            cache_position=cache_position, kv_valid_mask=kv_valid_mask, use_flash=use_flash,
            decode_emit=decode_emit, prefix_kv=prefix_kv, ring=ring, is_sliding=is_sliding,
            seq_parallel=sp)
    h = residual + attn_out
    residual = h
    hn = norm(h, lp["post_attention_layernorm"])
    moe_out = dcmoe_block(
        lp["moe"], hn, cfg, padding_token_mask=padding_token_mask,
        aux_balance_weight=aux_balance_weight, training=training, seed=seed,
        dispatch_mode=dispatch_mode, capacity=capacity, seq_parallel=sp)
    return LayerOutput(residual + moe_out.hidden_states, moe_out.aux_loss,
                       moe_out.router_top_k, kv, hn)


def text_model_forward(
    params: Dict,
    inputs_embeds: torch.Tensor,          # [B, T, D]
    position_ids: torch.Tensor,           # [3, B, T]
    cfg: TextMoEConfig,
    *,
    kv_cache: Optional[KVCache] = None,
    cache_position=None,                  # host int or 0-d device tensor
    kv_valid_mask: Optional[torch.Tensor] = None,
    padding_token_mask: Optional[torch.Tensor] = None,
    aux_balance_weight: Optional[torch.Tensor] = None,
    training: bool = False,
    seed: Optional[int] = None,
    remat: bool = False,
    use_flash: Optional[bool] = None,
    dispatch_mode: str = "dense",
    capacity: Optional[int] = None,
    output_moe_inputs: bool = False,
    decode_emit: Optional[bool] = None,
    prefix_kv=None,
    ring=None,
    seq_axis: Optional[str] = None,
) -> TextModelOutput:
    """Pre-norm attention + pre-norm DCMoE per layer with residuals, then
    the final RMSNorm (`model.py:55-266`).

    With a cache and one query position (decode_emit, unless the caller
    passes decode_emit=False) each layer attends over the stale cache plus
    its own fresh k/v; the fresh k/v are committed to the cache in place
    once that layer's attention is done, which is what the JAX package's
    batched commit after the layer scan amounts to (the mask keeps the
    current slot out of every layer's read).  decode_emit=False takes the
    general cache arithmetic instead: the step's k/v are written first and
    the layer attends over the whole cache, the current slot included, as a
    multi-frame forward does (`model.py:130-136`).

    Training: `seed` (a host int, in place of the JAX rng key) gives each
    layer its jitter seed (`fold_seed`); `remat` checkpoints each layer
    (`torch.utils.checkpoint`, non-reentrant), as `jax.checkpoint(layer_fn)`
    does, and the recompute draws the same jitter from the same seed.
    `dispatch_mode` and `capacity` go to every layer's DCMoE block.

    An int8 cache (`kv_cache.quantized`) quantizes on write, the decode
    commit included (`model.py:225-241`).  `output_moe_inputs` returns each
    layer's DCMoE block input (the post-attention RMSNorm output) in f32,
    the calibration statistic of GPTQ (`model.py:193-197`).

    prefix_kv: prefix-tuning (k, v), each [L, n, KV, Dh]; layer i attends
    over its slice ahead of its keys (no-cache path, `model.py:144-162`).

    Sliding-window layers (`cfg.layer_types`, `sliding_flags`) mask keys a
    window or more behind the query; a model that has any takes no flash
    kernel, in any layer (`model.py:113-122`).

    ring: a process group or (mesh, axis): every layer's attention runs as
    ring attention over it (`model.py:77, 192`); the causal no-cache path,
    without sliding layers.

    seq_axis="model": activation sequence sharding, the port's counterpart
    of the JAX package's `hidden_sharding` (`model.py:74, 87-101, 145-150,
    180-185`; there a GSPMD layout of the hidden states between blocks, B
    over (data, expert) and T over model).  Here it is Megatron sequence
    parallelism over the active mesh's model group, beside its tensor
    parallelism: between blocks each model rank holds T / |model| rows of
    the hidden states; the norms run on them; the normed rows are gathered
    over T before attention and before the DCMoE block (whose router sees
    the whole sequence, so its statistics are the whole batch's), whose
    row-split sums are reduce-scattered over T in place of the all-reduce.
    The final norm's output is gathered, so the result is the whole
    [B, T, D], as without it.  Without a model group it changes nothing.
    """
    B, T, _ = inputs_embeds.shape
    cos, sin = compute_mrope(position_ids, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
    use_cache = kv_cache is not None
    seq_group = None
    if seq_axis is not None:
        if seq_axis != "model":
            raise ValueError(f"seq_axis {seq_axis!r}: the sequence shards over the model axis "
                             "('model') only")
        if use_cache or ring is not None:
            raise ValueError("seq_axis is for the no-cache forward without ring attention")
        seq_group = tp_group()
        if T % group_size(seq_group):
            raise ValueError(f"seq_axis: T {T} does not split over "
                             f"{group_size(seq_group)} model ranks")
    if remat and use_cache:
        raise NotImplementedError("remat is for the no-cache (training) path")
    decode_emit = (decode_emit is not False and use_cache and T == 1
                   and cache_position is not None and kv_valid_mask is not None)
    quantized = use_cache and kv_cache.quantized
    layer_mask = kv_valid_mask
    if decode_emit:
        slots = torch.arange(kv_cache.k.shape[1], device=kv_valid_mask.device)
        layer_mask = kv_valid_mask * (slots[None, :] != cache_position).to(kv_valid_mask.dtype)
    sliding = sliding_flags(cfg, len(params["layers"]))
    if cfg.has_sliding_layers:
        use_flash = False                      # the flash kernel does not window

    def layer(i: int, lp: Dict, h: torch.Tensor, pre_k=None, pre_v=None):
        out = layer_apply(
            lp, h, cos, sin, cfg,
            kv_valid_mask=layer_mask, padding_token_mask=padding_token_mask,
            aux_balance_weight=aux_balance_weight, training=training,
            seed=fold_seed(seed, i) if training and seed is not None else None,
            use_flash=use_flash, dispatch_mode=dispatch_mode, capacity=capacity,
            is_sliding=sliding[i],
            prefix_kv=(pre_k, pre_v) if pre_k is not None else None,
            cache_kv=(kv_cache.k[i], kv_cache.v[i]) if use_cache else None,
            cache_scales=(kv_cache.k_scale[i], kv_cache.v_scale[i]) if quantized else None,
            cache_position=cache_position, decode_emit=decode_emit, ring=ring,
            seq_group=seq_group)
        if decode_emit:
            # In-place commit of this step's k/v (one [B, 1, KV, Dh] slot),
            # at a host int or a 0-d device position.
            k_new, v_new = out.kv[0].transpose(0, 1), out.kv[1].transpose(0, 1)
            if quantized:
                (k_new, k_s), (v_new, v_s) = quantize_kv(k_new), quantize_kv(v_new)
                write_slots(kv_cache.k_scale[i], cache_position, k_s)
                write_slots(kv_cache.v_scale[i], cache_position, v_s)
            write_slots(kv_cache.k[i], cache_position, k_new)
            write_slots(kv_cache.v[i], cache_position, v_new)
        moe_in = out.moe_input.float() if output_moe_inputs else None
        return out.hidden, out.aux_loss, out.router_top_k, moe_in

    h = scatter_dim(inputs_embeds, seq_group, 1)
    aux, top_k, moe_inputs = [], [], []
    for i, lp in enumerate(params["layers"]):
        pre = (prefix_kv[0][i], prefix_kv[1][i]) if prefix_kv is not None else ()
        if remat and torch.is_grad_enabled():
            h, aux_i, top_k_i, moe_in = checkpoint(layer, i, lp, h, *pre, use_reentrant=False)
        else:
            h, aux_i, top_k_i, moe_in = layer(i, lp, h, *pre)
        aux.append(aux_i)
        top_k.append(top_k_i)
        moe_inputs.append(moe_in)
    h = gather_dim(rms_norm(h, copy_to(params["norm"], seq_group), cfg.rms_norm_eps),
                   seq_group, 1)
    return TextModelOutput(
        last_hidden_state=h, kv_cache=kv_cache,
        aux_loss=torch.stack(aux), router_top_k=torch.stack(top_k),
        moe_inputs=torch.stack(moe_inputs) if output_moe_inputs else None)


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


def align_codec_ids(input_ids, flat_codec_ids, placeholder_id) -> np.ndarray:
    """Host numpy: the reference's flat [N, C] codec rows → an aligned
    [B, T, C] array, row j at the j-th placeholder position in reading order
    (what masked_scatter does); other positions 0.  The placeholder count
    must equal N."""
    input_ids = np.asarray(input_ids)
    flat = np.asarray(flat_codec_ids)
    B, T = input_ids.shape
    out = np.zeros((B, T, flat.shape[-1]), dtype=flat.dtype)
    pos = np.argwhere(input_ids == placeholder_id)
    assert len(pos) == flat.shape[0], (
        f"placeholder count {len(pos)} != codec rows {flat.shape[0]}")
    out[pos[:, 0], pos[:, 1]] = flat
    return out


def get_rope_index(input_ids, cfg: UniMoEAudioConfig, *, image_grid_thw=None,
                   video_grid_thw=None, second_per_grid_ts=None, attention_mask=None):
    """mRoPE position ids of text + vision sequences, host numpy
    (`model.py:321-409`): text tokens advance the three rows together; each
    image or video span advances (t, h, w) over its merged grid, video time
    scaled by second_per_grid_t x tokens_per_second; left pads (mask 0)
    take position 1.  Returns (position_ids [3, B, T], rope_deltas [B, 1]),
    the delta being max position + 1 - T per row (negative after a vision
    span)."""
    input_ids = np.asarray(input_ids)
    B, T = input_ids.shape
    if image_grid_thw is None and video_grid_thw is None:
        if attention_mask is not None:
            mask = np.asarray(attention_mask)
            pos = np.where(mask == 0, 1, np.cumsum(mask, axis=-1) - 1)
            position_ids = np.broadcast_to(pos[None], (3, B, T)).copy()
            deltas = position_ids.max(axis=0).max(axis=-1, keepdims=True) + 1 - T
            return position_ids, deltas
        pos = np.broadcast_to(np.arange(T)[None], (B, T))
        return np.broadcast_to(pos[None], (3, B, T)).copy(), np.zeros((B, 1), np.int64)

    sms = cfg.vision_config.spatial_merge_size
    tps = cfg.vision_config.tokens_per_second
    attention_mask = np.ones_like(input_ids) if attention_mask is None \
        else np.asarray(attention_mask)
    position_ids = np.ones((3, B, T), dtype=np.int64)
    deltas = []
    img_i = vid_i = 0
    for b in range(B):
        ids = input_ids[b][attention_mask[b] == 1]
        toks = ids.tolist()
        vis_starts = np.where(ids == cfg.vision_start_token_id)[0]
        vis_starts = vis_starts[vis_starts + 1 < len(ids)]        # drop a dangling span
        vis_kinds = ids[vis_starts + 1] if len(vis_starts) else np.array([])
        remain_i = n_images = int((vis_kinds == cfg.image_token_id).sum())
        remain_v = n_videos = int((vis_kinds == cfg.video_token_id).sum())
        parts = []
        st = 0
        for _ in range(n_images + n_videos):
            ed_img = toks.index(cfg.image_token_id, st) if (
                cfg.image_token_id in toks[st:] and remain_i > 0) else len(toks) + 1
            ed_vid = toks.index(cfg.video_token_id, st) if (
                cfg.video_token_id in toks[st:] and remain_v > 0) else len(toks) + 1
            if ed_img < ed_vid:
                t, h, w = np.asarray(image_grid_thw)[img_i]
                spgt = 0
                img_i += 1
                remain_i -= 1
                ed = ed_img
            else:
                t, h, w = np.asarray(video_grid_thw)[vid_i]
                spgt = second_per_grid_ts[vid_i] if second_per_grid_ts is not None else 1.0
                vid_i += 1
                remain_v -= 1
                ed = ed_vid
            gt, gh, gw = int(t), int(h) // sms, int(w) // sms
            text_len = ed - st
            st_idx = parts[-1].max() + 1 if parts else 0
            parts.append(np.broadcast_to(np.arange(text_len)[None], (3, text_len)) + st_idx)
            t_idx = (np.arange(gt)[:, None] * spgt * tps).astype(np.int64)
            t_idx = np.broadcast_to(t_idx, (gt, gh * gw)).reshape(-1)
            h_idx = np.broadcast_to(np.arange(gh)[None, :, None], (gt, gh, gw)).reshape(-1)
            w_idx = np.broadcast_to(np.arange(gw)[None, None, :], (gt, gh, gw)).reshape(-1)
            parts.append(np.stack([t_idx, h_idx, w_idx]) + text_len + st_idx)
            st = ed + gt * gh * gw
        if st < len(toks):
            st_idx = parts[-1].max() + 1 if parts else 0
            text_len = len(toks) - st
            parts.append(np.broadcast_to(np.arange(text_len)[None], (3, text_len)) + st_idx)
        llm_pos = np.concatenate(parts, axis=1)
        position_ids[:, b, attention_mask[b] == 1] = llm_pos
        deltas.append(llm_pos.max() + 1 - len(input_ids[b]))
    return position_ids, np.asarray(deltas)[:, None]


def scatter_vision_features(inputs_embeds: torch.Tensor, input_ids: torch.Tensor,
                            feats: torch.Tensor, token_id: int,
                            offset: int = 0) -> torch.Tensor:
    """Order-preserving scatter: the j-th `token_id` slot of the flattened
    batch, in reading order, takes feats[offset + j] (`model.py:474-491`;
    offset: the slots of the rows before these, under a split batch)."""
    B, T = input_ids.shape
    vmask = input_ids == token_id
    slot = torch.cumsum(vmask.reshape(-1), 0) - 1 + offset
    gathered = feats[slot.clamp(0, feats.shape[0] - 1)].reshape(B, T, -1)
    return torch.where(vmask[..., None], gathered.to(inputs_embeds.dtype), inputs_embeds)


def head_logits(hidden: torch.Tensor, w) -> torch.Tensor:
    """hidden @ w in f32.  On an active mesh's model group w holds this
    rank's output columns: hidden enters through `copy_to` and the logits
    are all-gathered over the group."""
    tp = tp_group()
    return gather_dim(matmul(copy_to(hidden, tp), w).float(), tp, -1)


def codec_logits_from_hidden(params: Dict, hidden: torch.Tensor,
                             cfg: UniMoEAudioConfig) -> torch.Tensor:
    """[B, T, D] → [B, T, C, Vc] codec logits (fp32)."""
    flat = head_logits(hidden, params["codec_head"])
    B, T = hidden.shape[:2]
    return flat.reshape(B, T, cfg.codec_channels, cfg.codec_embed_size)


class ModelOutput(NamedTuple):
    loss: Optional[torch.Tensor]
    codec_loss: Optional[torch.Tensor]
    aux_loss: torch.Tensor
    logits: Optional[torch.Tensor]
    codec_logits: torch.Tensor
    router_top_k: torch.Tensor


def _shifted_ce(logits: torch.Tensor, labels: torch.Tensor, dims) -> torch.Tensor:
    """Next-token cross-entropy: logits [B, T, ..., V] against labels
    [B, T, ...] shifted by one position, -100 ignored; the sum of the NLL
    over `dims` divided by the count of valid labels there (at least 1).
    Under a split batch (`parallel/mesh.batch_group`) the sum and the count
    are the whole batch's."""
    shift_logits = logits[:, :-1]
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    group = batch_group()
    return reduce_from(nll.sum(dim=dims), group) / \
        all_reduce(valid.sum(dim=dims), group).clamp_min(1)


def model_forward(
    params: Dict,
    cfg: UniMoEAudioConfig,
    input_ids: torch.Tensor,
    *,
    codec_input_ids: Optional[torch.Tensor] = None,   # [B, T, C] aligned
    attention_mask: Optional[torch.Tensor] = None,    # [B, T]
    position_ids: Optional[torch.Tensor] = None,      # [3, B, T]
    inputs_embeds: Optional[torch.Tensor] = None,
    codec_labels: Optional[torch.Tensor] = None,      # [B, T, C], -100 = ignore
    labels: Optional[torch.Tensor] = None,            # [B, T] text labels, -100 = ignore
    aux_balance_weight: Optional[torch.Tensor] = None,
    aux_loss_weight=0.0,
    pixel_values: Optional[torch.Tensor] = None,         # [S_patches, patch_dim]
    image_grid_thw=None,                                 # host numpy [n, 3]
    pixel_values_videos: Optional[torch.Tensor] = None,
    video_grid_thw=None,
    training: bool = False,
    seed: Optional[int] = None,
    remat: bool = False,
    use_flash: Optional[bool] = None,
    dispatch_mode: str = "dense",
    capacity: Optional[int] = None,
    prefix_kv=None,                                      # ([L, n, KV, Dh], same)
    ring=None,
    seq_axis: Optional[str] = None,
) -> ModelOutput:
    """Full-model forward without a cache — the training / eval path
    (`model.py:432-567`): input embedding with the codec scatter, the
    decoder stack, the lm and codec heads, the per-channel shifted codec CE
    summed over channels, the optional text-label CE, plus
    aux_loss_weight · mean(aux).  Image and video patches go through the
    vision tower (`params["vision"]`) and its features replace the
    embeddings of the image and video token slots, in reading order.
    With prefix_kv (prefix tuning) the learned keys take positions [0, n),
    so every position id, explicit ones included, shifts by n
    (`model.py:496-501`).  ring and seq_axis go to `text_model_forward`
    (`model.py:518-519`)."""
    tc = cfg.text_config
    B, T = input_ids.shape
    if attention_mask is None:
        attention_mask = torch.ones(B, T, dtype=torch.int32, device=input_ids.device)
    if inputs_embeds is None:
        inputs_embeds = calculate_input_embedding(
            params, input_ids, codec_input_ids, cfg.codec_placeholder_value)
    for pv, grid, tok_id in ((pixel_values, image_grid_thw, cfg.image_token_id),
                             (pixel_values_videos, video_grid_thw, cfg.video_token_id)):
        if pv is not None:
            feats = vision_forward(params["vision"], pv, grid, cfg.vision_config)
            inputs_embeds = scatter_vision_features(inputs_embeds, input_ids, feats, tok_id)
    if position_ids is None:
        pos = torch.cumsum(attention_mask, dim=-1) - 1
        pos = torch.where(attention_mask == 0, torch.ones_like(pos), pos)
        position_ids = pos[None].expand(3, B, T)
    if prefix_kv is not None:
        position_ids = position_ids + prefix_kv[0].shape[1]
    abw = None
    if aux_balance_weight is not None:
        abw = attention_mask * aux_balance_weight

    out = text_model_forward(
        params, inputs_embeds, position_ids, tc,
        kv_valid_mask=attention_mask, padding_token_mask=attention_mask,
        aux_balance_weight=abw, training=training, seed=seed, remat=remat,
        use_flash=use_flash, dispatch_mode=dispatch_mode, capacity=capacity,
        prefix_kv=prefix_kv, ring=ring, seq_axis=seq_axis)
    hidden = out.last_hidden_state

    logits = None
    if labels is not None:
        logits = head_logits(hidden, params["lm_head"])
    codec_logits = codec_logits_from_hidden(params, hidden, cfg)

    loss = codec_loss = None
    mean_aux = out.aux_loss.mean()
    if labels is not None:
        loss = _shifted_ce(logits, labels, (0, 1)) + aux_loss_weight * mean_aux
    if codec_labels is not None:
        # Per-channel mean NLL, summed over channels; a channel with no
        # label contributes 0.
        codec_loss = _shifted_ce(codec_logits, codec_labels, (0, 1)).sum()
        loss = (loss if loss is not None else aux_loss_weight * mean_aux) + codec_loss
    return ModelOutput(loss=loss, codec_loss=codec_loss, aux_loss=mean_aux, logits=logits,
                       codec_logits=codec_logits, router_top_k=out.router_top_k)


def init_layer_params(gen: torch.Generator, cfg: TextMoEConfig, *, dtype=torch.bfloat16,
                      device="cuda") -> Dict:
    """One decoder layer's random weights, drawn from `gen` on `device` (the
    layer of `init_model_params`)."""
    ones = torch.ones(cfg.hidden_size, dtype=dtype, device=device)
    return {"input_layernorm": ones, "post_attention_layernorm": ones.clone(),
            "attn": init_attention_params(gen, cfg, dtype=dtype, device=device),
            "moe": init_dcmoe_params(gen, cfg, dtype=dtype, device=device)}


def init_outer_params(gen: torch.Generator, cfg: UniMoEAudioConfig, *, dtype=torch.bfloat16,
                      device="cuda") -> Dict:
    """The random weights outside the layer stack (embeddings, final norm,
    heads), drawn from `gen` after the layers, as `init_model_params` does."""
    tc = cfg.text_config
    Dm, V = tc.hidden_size, tc.vocab_size
    C, Vc = cfg.codec_channels, cfg.codec_embed_size
    std = tc.initializer_range

    def nrm(shape, scale):
        return torch.randn(*shape, generator=gen, dtype=dtype, device=device).mul_(scale)

    return {
        "embed_tokens": nrm((V, Dm), std),
        "norm": torch.ones(Dm, dtype=dtype, device=device),
        "lm_head": nrm((Dm, V), Dm ** -0.5),
        "codec_embed": nrm((C, Vc, Dm), std),
        "codec_head": nrm((Dm, C * Vc), Dm ** -0.5),
    }


def init_model_params(cfg: UniMoEAudioConfig, *, seed: int = 0, dtype=torch.bfloat16,
                      device="cuda", with_vision: bool = False) -> Dict:
    """Random weights made directly on `device`, tensor by tensor in the
    working dtype (the DCMoE router stays f32, as in the JAX init), from a
    seeded torch.Generator on that device: the layers in order, then the
    outer weights.  The layout and scales follow `init_model_params` in the
    JAX package; the numbers differ (another generator).  with_vision adds
    the vision tower when the config has one, from a generator of its own
    (seed `fold_seed(seed, 6)`), so the decoder's weights are the same with
    and without it."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    layers = [init_layer_params(gen, cfg.text_config, dtype=dtype, device=device)
              for _ in range(cfg.text_config.num_hidden_layers)]
    outer = init_outer_params(gen, cfg, dtype=dtype, device=device)
    params = {"embed_tokens": outer.pop("embed_tokens"), "layers": layers, **outer}
    if with_vision and cfg.vision_config is not None:
        params["vision"] = init_vision_params(cfg.vision_config, seed=fold_seed(seed, 6),
                                              dtype=dtype, device=device)
    return params
