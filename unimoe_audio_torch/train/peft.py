"""Prompt, P- and prefix tuning of the port — counterpart of
`unimoe_audio_tpu/train/peft.py` (LoRA is `train/lora.py`).

The adapters are a tree at `params["peft"]`, so the optimizer, the
checkpoints and `trainable_pattern="peft"` treat them as any parameter:

  prompt tuning   params["peft"]["prompt"]  = {"embed": [n, D]}
  P-tuning        params["peft"]["ptuning"] = {"embed": [n, D], "mlp": ...}
  prefix tuning   params["peft"]["prefix"]  = {"embed": [n, D], "mlp": ...}

Prompt and P-tuning give `virtual_embeds` [n, D], prepended to the input
embeddings (training: `prepend_virtual_tokens`; generation: through the
loop's visual_embeds scatter, `api._generate_core`).  Prefix tuning gives
per-layer keys and values [L, n, KV, Dh], post-RoPE, ahead of every layer's
keys: concatenated in the no-cache path (`models/layers.attention`), written
into cache slots [0, n) for generation (`generate/loop.generate`).  The
defaults are the JAX package's: 10 virtual tokens, an encoder of width 512.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..config import UniMoEAudioConfig

N_VIRTUAL_TOKENS = 10
ENCODER_HIDDEN = 512


def _nrm(gen, shape, scale, dtype, device):
    return torch.randn(*shape, generator=gen, device=device).mul_(scale).to(dtype)


def _mlp(gen, din, dh, dout, dtype, device):
    return {"w1": _nrm(gen, (din, dh), din ** -0.5, dtype, device),
            "b1": torch.zeros(dh, dtype=dtype, device=device),
            "w2": _nrm(gen, (dh, dout), dh ** -0.5, dtype, device),
            "b2": torch.zeros(dout, dtype=dtype, device=device)}


def init_prompt_tuning(gen: torch.Generator, cfg: UniMoEAudioConfig, *,
                       n_virtual: int = N_VIRTUAL_TOKENS, dtype=torch.float32,
                       device="cuda") -> Dict:
    """A learnable soft-prompt table N(0, 0.02²) [n, D] (`peft.py:38-46`)."""
    D = cfg.text_config.hidden_size
    return {"prompt": {"embed": _nrm(gen, (n_virtual, D), 0.02, dtype, device)}}


def init_p_tuning(gen: torch.Generator, cfg: UniMoEAudioConfig, *,
                  n_virtual: int = N_VIRTUAL_TOKENS, encoder_hidden: int = ENCODER_HIDDEN,
                  dtype=torch.float32, device="cuda") -> Dict:
    """Soft prompts re-parameterized by an MLP encoder, embed → Linear →
    ReLU → Linear (`peft.py:49-65`)."""
    D = cfg.text_config.hidden_size
    return {"ptuning": {"embed": _nrm(gen, (n_virtual, D), 0.02, dtype, device),
                        "mlp": _mlp(gen, D, encoder_hidden, D, dtype, device)}}


def init_prefix_tuning(gen: torch.Generator, cfg: UniMoEAudioConfig, *,
                       n_virtual: int = N_VIRTUAL_TOKENS, encoder_hidden: int = ENCODER_HIDDEN,
                       dtype=torch.float32, device="cuda") -> Dict:
    """Soft prompts projected by an MLP to every layer's keys and values
    (prefix_projection, `peft.py:68-87`)."""
    tc = cfg.text_config
    D = tc.hidden_size
    out = tc.num_hidden_layers * 2 * tc.num_key_value_heads * tc.head_dim
    return {"prefix": {"embed": _nrm(gen, (n_virtual, D), 0.02, dtype, device),
                       "mlp": _mlp(gen, D, encoder_hidden, out, dtype, device)}}


def virtual_embeds(peft: Dict) -> Optional[torch.Tensor]:
    """[n, D] soft-prompt embeddings of prompt or P-tuning; None for prefix
    tuning (`peft.py:90-98`)."""
    if "prompt" in peft:
        return peft["prompt"]["embed"]
    if "ptuning" in peft:
        p = peft["ptuning"]
        h = torch.relu(p["embed"] @ p["mlp"]["w1"] + p["mlp"]["b1"])
        return h @ p["mlp"]["w2"] + p["mlp"]["b2"]
    return None


def prefix_kv(peft: Dict, cfg: UniMoEAudioConfig) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer prefix (k, v), each [L, n, KV, Dh], or None without prefix
    tuning (`peft.py:101-114`).  Post-RoPE: the learned keys carry no rotary
    position, and the real tokens' positions shift by n."""
    if "prefix" not in peft:
        return None
    tc = cfg.text_config
    p = peft["prefix"]
    n = p["embed"].shape[0]
    h = torch.relu(p["embed"] @ p["mlp"]["w1"] + p["mlp"]["b1"])
    flat = h @ p["mlp"]["w2"] + p["mlp"]["b2"]
    kv = flat.reshape(n, tc.num_hidden_layers, 2, tc.num_key_value_heads, tc.head_dim)
    kv = kv.movedim(0, 2)                                        # [L, 2, n, KV, Dh]
    return kv[:, 0], kv[:, 1]


def prepend_virtual_tokens(batch: Dict, inputs_embeds: torch.Tensor,
                           virt: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """n soft tokens ahead of a training batch (`peft.py:117-151`): the
    embeddings get the virtual rows; input_ids 0, the mask 1, labels and
    codec labels -100, codec ids 0 and the aux weight 1 ahead of theirs;
    explicit mRoPE positions [3, B, T] get [0, n) ahead and shift by n."""
    B, T, D = inputs_embeds.shape
    n = virt.shape[0]
    out = dict(batch)
    emb = torch.cat([virt[None].to(inputs_embeds.dtype).expand(B, n, D), inputs_embeds], dim=1)

    def pre(x, value):
        pad = torch.full((B, n) + tuple(x.shape[2:]), value, dtype=x.dtype, device=x.device)
        return torch.cat([pad, x], dim=1)

    out["input_ids"] = pre(batch["input_ids"], 0)
    if batch.get("attention_mask") is not None:
        out["attention_mask"] = pre(batch["attention_mask"], 1)
    for key, fill in (("labels", -100), ("codec_labels", -100), ("codec_input_ids", 0),
                      ("aux_balance_weight", 1)):
        if batch.get(key) is not None:
            out[key] = pre(batch[key], fill)
    if batch.get("position_ids") is not None:
        pos = batch["position_ids"]                                  # [3, B, T]
        vpos = torch.arange(n, dtype=pos.dtype, device=pos.device).expand(*pos.shape[:2], n)
        out["position_ids"] = torch.cat([vpos, pos + n], dim=-1)
    return out, emb
