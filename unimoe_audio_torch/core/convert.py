"""Weight converters: torch / HF checkpoints → the JAX package's param
layout, with numpy and torch only — counterpart of
`unimoe_audio_tpu/core/convert.py`.

Two weight sources:
  * the DAC codec checkpoint `weights_16khz.pth` (torch, weight-normed
    convs), read with `torch.load`;
  * UniMoE-Audio HF safetensors shards, read by `load_hf_safetensors`, the
    port's own reader of the format (no `safetensors` package needed).

Rules, as in the JAX package: weight-norm (g, v) pairs fold into one
weight W = g · v / ‖v‖ (the norm over every dim but 0); torch Linear
weights [out, in] transpose to [in, out]; per-layer tensors stack on a
leading [L] axis and per-expert FFN weights on [E].  The outputs are numpy
trees in the JAX layout; `core/bridge.params_from_jax` makes the port's
tensors of them.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
from typing import Any, Dict, Optional

import numpy as np
import torch


def _np(t) -> np.ndarray:
    """A torch tensor → f32 numpy; anything else → numpy as it is."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu").float().numpy()
    return np.asarray(t)


def fold_weight_norm(g: np.ndarray, v: np.ndarray) -> np.ndarray:
    """W = g · v / ‖v‖, the norm over all dims except 0 (weight_norm dim=0),
    computed in f64 and returned in f32."""
    axes = tuple(range(1, v.ndim))
    v64 = v.astype(np.float64)
    norm = np.sqrt(np.sum(v64 ** 2, axis=axes, keepdims=True))
    return (g.astype(np.float64) * v64 / np.maximum(norm, 1e-12)).astype(np.float32)


# ---------------------------------------------------------------------------
# DAC codec
# ---------------------------------------------------------------------------

def _wn_conv(sd: Dict[str, Any], prefix: str):
    """A weight-normed conv of a torch state dict, folded: (w, b or None).
    Reads the weight_g / weight_v names, torch's parametrization names
    (original0 / original1) and a plain weight."""
    if f"{prefix}.weight_g" in sd:
        w = fold_weight_norm(_np(sd[f"{prefix}.weight_g"]), _np(sd[f"{prefix}.weight_v"]))
    elif f"{prefix}.parametrizations.weight.original0" in sd:
        w = fold_weight_norm(_np(sd[f"{prefix}.parametrizations.weight.original0"]),
                             _np(sd[f"{prefix}.parametrizations.weight.original1"]))
    else:
        w = _np(sd[f"{prefix}.weight"])
    b = _np(sd[f"{prefix}.bias"]) if f"{prefix}.bias" in sd else None
    return w, b


def convert_dac_state_dict(sd: Dict[str, Any], *, n_enc_blocks: int = 4,
                           n_dec_blocks: int = 4, n_codebooks: int = 12) -> Dict:
    """A descript-audio-codec state dict → the DAC param tree
    (`codec/dac.py` layout).  Module paths:
      encoder.block: [0] conv_in, [1..N] EncoderBlock, [N+1] Snake, [N+2] conv_out
      EncoderBlock.block: [0..2] ResidualUnit, [3] Snake, [4] strided conv
      ResidualUnit.block: [0] Snake, [1] conv k7, [2] Snake, [3] conv k1
      decoder.model: [0] conv_in, [1..N] DecoderBlock, [N+1] Snake, [N+2] conv_out
      DecoderBlock.block: [0] Snake, [1] conv_transpose, [2..4] ResidualUnit
      quantizer.quantizers.{i}.{in_proj, out_proj, codebook}
    """

    def res_unit(prefix):
        w1, b1 = _wn_conv(sd, f"{prefix}.block.1")
        w2, b2 = _wn_conv(sd, f"{prefix}.block.3")
        return {"snake1_alpha": _np(sd[f"{prefix}.block.0.alpha"]), "conv1_w": w1, "conv1_b": b1,
                "snake2_alpha": _np(sd[f"{prefix}.block.2.alpha"]), "conv2_w": w2, "conv2_b": b2}

    enc_in_w, enc_in_b = _wn_conv(sd, "encoder.block.0")
    enc_blocks = []
    for i in range(1, n_enc_blocks + 1):
        p = f"encoder.block.{i}.block"
        w, b = _wn_conv(sd, f"{p}.4")
        enc_blocks.append({"res": [res_unit(f"{p}.{j}") for j in range(3)],
                           "snake_alpha": _np(sd[f"{p}.3.alpha"]), "conv_w": w, "conv_b": b})
    enc_out_w, enc_out_b = _wn_conv(sd, f"encoder.block.{n_enc_blocks + 2}")
    encoder = {"conv_in_w": enc_in_w, "conv_in_b": enc_in_b, "blocks": enc_blocks,
               "snake_out_alpha": _np(sd[f"encoder.block.{n_enc_blocks + 1}.alpha"]),
               "conv_out_w": enc_out_w, "conv_out_b": enc_out_b}

    quantizers = []
    for i in range(n_codebooks):
        p = f"quantizer.quantizers.{i}"
        wi, bi = _wn_conv(sd, f"{p}.in_proj")
        wo, bo = _wn_conv(sd, f"{p}.out_proj")
        quantizers.append({"in_proj_w": wi, "in_proj_b": bi, "out_proj_w": wo, "out_proj_b": bo,
                           "codebook": _np(sd[f"{p}.codebook.weight"])})

    dec_in_w, dec_in_b = _wn_conv(sd, "decoder.model.0")
    dec_blocks = []
    for i in range(1, n_dec_blocks + 1):
        p = f"decoder.model.{i}.block"
        wt, bt = _wn_conv(sd, f"{p}.1")
        dec_blocks.append({"snake_alpha": _np(sd[f"{p}.0.alpha"]), "convt_w": wt, "convt_b": bt,
                           "res": [res_unit(f"{p}.{j}") for j in range(2, 5)]})
    dec_out_w, dec_out_b = _wn_conv(sd, f"decoder.model.{n_dec_blocks + 2}")
    decoder = {"conv_in_w": dec_in_w, "conv_in_b": dec_in_b, "blocks": dec_blocks,
               "snake_out_alpha": _np(sd[f"decoder.model.{n_dec_blocks + 1}.alpha"]),
               "conv_out_w": dec_out_w, "conv_out_b": dec_out_b}
    return {"encoder": encoder, "quantizer": {"quantizers": quantizers}, "decoder": decoder}


def convert_dac_weights(torch_path: str, out_path: str) -> None:
    """weights_16khz.pth → a pickle {"params": numpy f32 tree, "config":
    DACConfig fields}, the file `codec/dac_wrapper.Dac` loads (the same
    format as the JAX package's converter writes)."""
    from ..codec.dac import DACConfig

    blob = torch.load(torch_path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob)
    meta = blob.get("metadata", {}).get("kwargs", {})
    cb_dim = meta.get("codebook_dim", 8)
    cfg = DACConfig(
        encoder_dim=meta.get("encoder_dim", 64),
        encoder_rates=tuple(meta.get("encoder_rates", (2, 4, 5, 8))),
        decoder_dim=meta.get("decoder_dim", 1536),
        decoder_rates=tuple(meta.get("decoder_rates", (8, 5, 4, 2))),
        n_codebooks=meta.get("n_codebooks", 12),
        codebook_size=meta.get("codebook_size", 1024),
        codebook_dim=cb_dim[0] if isinstance(cb_dim, list) else cb_dim,
        sample_rate=meta.get("sample_rate", 16000),
    )
    params = convert_dac_state_dict(sd, n_enc_blocks=len(cfg.encoder_rates),
                                    n_dec_blocks=len(cfg.decoder_rates),
                                    n_codebooks=cfg.n_codebooks)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump({"params": params, "config": cfg.__dict__}, f)


# ---------------------------------------------------------------------------
# UniMoE-Audio main model
# ---------------------------------------------------------------------------

def convert_model_state_dict(sd: Dict[str, Any], cfg) -> Dict:
    """An HF UniMoE-Audio state dict → the layer-stacked param tree of the
    JAX layout (numpy leaves).  Names:
      language_model.embed_tokens.weight                          [V, D]
      language_model.layers.{l}.input_layernorm.weight
      language_model.layers.{l}.self_attn.{q,k,v,o}_proj.weight / bias
      language_model.layers.{l}.post_attention_layernorm.weight
      language_model.layers.{l}.mlp.gate.weight
      language_model.layers.{l}.mlp.fixed_real_moe.{j}.{gate,up,down}_proj.weight
      language_model.layers.{l}.mlp.dynamic_real_moe.deepspeed_moe.experts.
          deepspeed_experts.{e}.{gate,up,down}_proj.weight
      language_model.norm.weight / lm_head.weight (tied to the embedding
          when absent)
      codec_embed_tokens.{c}.weight / codec_head.weight
    Bias-free q/k/v get zero biases.  When the config has a vision tower
    and the state dict holds its weights, `visual.*` goes through
    `convert_vision_state_dict` into "vision"."""
    tc = cfg.text_config
    L = tc.num_hidden_layers

    def get(name, transpose=False):
        t = _np(sd[name])
        return t.T if transpose else t

    def layer_stack(fmt, transpose=False):
        return np.stack([get(fmt.format(l=l), transpose) for l in range(L)])

    def attn_proj(which):
        w = layer_stack("language_model.layers.{l}.self_attn.%s.weight" % which, transpose=True)
        p = {"w": w}
        if f"language_model.layers.0.self_attn.{which}.bias" in sd:
            p["b"] = layer_stack("language_model.layers.{l}.self_attn.%s.bias" % which)
        elif which != "o_proj":
            p["b"] = np.zeros((L, w.shape[-1]), dtype=w.dtype)
        return p

    def expert_stack(fmt, n, proj):                              # [L, n, din, dout]
        return np.stack([np.stack([get(fmt.format(l=l, e=e) + f".{proj}_proj.weight", True)
                                   for e in range(n)]) for l in range(L)])

    dyn = ("language_model.layers.{l}.mlp.dynamic_real_moe.deepspeed_moe.experts."
           "deepspeed_experts.{e}")
    fixed = "language_model.layers.{l}.mlp.fixed_real_moe.{e}"
    layers = {
        "input_layernorm": layer_stack("language_model.layers.{l}.input_layernorm.weight"),
        "post_attention_layernorm": layer_stack(
            "language_model.layers.{l}.post_attention_layernorm.weight"),
        "attn": {
            "q_proj": attn_proj("q_proj"),
            "k_proj": attn_proj("k_proj"),
            "v_proj": attn_proj("v_proj"),
            "o_proj": {"w": layer_stack("language_model.layers.{l}.self_attn.o_proj.weight",
                                        transpose=True)},
        },
        "moe": {
            "gate": layer_stack("language_model.layers.{l}.mlp.gate.weight", transpose=True),
            "dynamic": {p: expert_stack(dyn, tc.mlp_dynamic_expert_num, p)
                        for p in ("gate", "up", "down")},
            "fixed": {p: expert_stack(fixed, tc.mlp_fixed_expert_num, p)
                      for p in ("gate", "up", "down")},
        },
    }
    params = {
        "embed_tokens": get("language_model.embed_tokens.weight"),
        "layers": layers,
        "norm": get("language_model.norm.weight"),
        "lm_head": (get("lm_head.weight", transpose=True) if "lm_head.weight" in sd
                    else get("language_model.embed_tokens.weight").T),
        "codec_embed": np.stack([get(f"codec_embed_tokens.{c}.weight")
                                 for c in range(cfg.codec_channels)]),
        "codec_head": get("codec_head.weight", transpose=True),
    }
    if cfg.vision_config is not None and "visual.patch_embed.proj.weight" in sd:
        params["vision"] = convert_vision_state_dict(sd, cfg.vision_config)
    return params


def convert_vision_state_dict(sd: Dict[str, Any], vcfg) -> Dict:
    """The HF `visual.*` weights → the vision tower's layout
    (`models/vision.py`, numpy leaves; `convert.py:277-319`).  The conv3d
    patch embed [D, C, tps, ps, ps] flattens to a [C·tps·ps·ps, D] matmul
    weight (kernel == stride, so the two are equal).  Names:
      visual.patch_embed.proj.weight
      visual.blocks.{i}.norm1.weight / norm2.weight
      visual.blocks.{i}.attn.qkv / attn.proj .weight / .bias
      visual.blocks.{i}.mlp.{gate,up,down}_proj .weight / .bias
      visual.merger.ln_q.weight, visual.merger.mlp.{0,2} .weight / .bias
    A missing bias becomes zeros (f32)."""

    def get(name, transpose=False):
        t = _np(sd[name])
        return t.T if transpose else t

    def lin(prefix):
        w = get(f"{prefix}.weight", transpose=True)
        b = get(f"{prefix}.bias") if f"{prefix}.bias" in sd else \
            np.zeros(w.shape[-1], dtype=np.float32)
        return {"w": w, "b": b}

    pe = _np(sd["visual.patch_embed.proj.weight"])              # [D, C, tps, ps, ps]
    blocks = [{
        "norm1": get(f"visual.blocks.{i}.norm1.weight"),
        "norm2": get(f"visual.blocks.{i}.norm2.weight"),
        "qkv": lin(f"visual.blocks.{i}.attn.qkv"),
        "proj": lin(f"visual.blocks.{i}.attn.proj"),
        "mlp": {p: lin(f"visual.blocks.{i}.mlp.{p}_proj") for p in ("gate", "up", "down")},
    } for i in range(vcfg.depth)]
    return {
        "patch_embed": pe.reshape(pe.shape[0], -1).T,
        "blocks": blocks,
        "merger": {"ln_q": get("visual.merger.ln_q.weight"),
                   "fc1": lin("visual.merger.mlp.0"), "fc2": lin("visual.merger.mlp.2")},
    }


# safetensors dtype names → (numpy dtype of the stored bytes, torch dtype).
_ST_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One .safetensors file → {name: CPU tensor}.  The format: an 8-byte
    little-endian header length, a JSON header mapping each name to its
    dtype, shape and [begin, end) byte offsets into the data that follows
    (plus an optional "__metadata__"), then the raw little-endian bytes.
    BF16 is read as 16-bit words viewed as torch.bfloat16."""
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: {name} has unsupported dtype {info['dtype']}")
        np_dtype, t_dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        arr = np.frombuffer(data, dtype=np.dtype(np_dtype).newbyteorder("<"),
                            count=(end - begin) // np.dtype(np_dtype).itemsize, offset=begin)
        t = torch.from_numpy(arr.astype(np_dtype).reshape(info["shape"]))
        out[name] = t.view(t_dtype) if t_dtype == torch.bfloat16 else t
    return out


_ST_NAMES = {t: name for name, (_, t) in _ST_DTYPES.items()}


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> int:
    """Write {name: tensor} as one .safetensors file, `read_safetensors`'
    format (and the `safetensors` package's): the 8-byte little-endian
    header length, the JSON header padded with spaces to a multiple of 8,
    then each tensor's raw little-endian bytes in the order given (F32,
    BF16, F16 and the integer types; bf16 as its 16-bit words).  Returns
    the bytes written."""
    header: Dict[str, Any] = {}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: no safetensors dtype for {t.dtype}")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    if metadata:
        header["__metadata__"] = metadata
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().data)
    return 8 + len(head) + offset


def load_hf_safetensors(model_dir: str) -> Dict[str, torch.Tensor]:
    """Every *.safetensors shard in an HF checkpoint directory, in name
    order, merged into one dict."""
    sd: Dict[str, torch.Tensor] = {}
    for fname in sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors")):
        sd.update(read_safetensors(os.path.join(model_dir, fname)))
    return sd


def convert_model_weights(model_dir: str, out_path: str, dtype="bfloat16") -> None:
    """An HF checkpoint directory (config.json + safetensors) → a pickle
    {"params": tree, "config": dict} with floating leaves cast to dtype and
    the router gate kept in f32.  numpy has no bf16, so bf16 leaves are
    stored as {"__bf16__": uint16 bits}, as the port's serving snapshots
    store them (`core/export.py`), and the file unpickles with numpy
    alone."""
    from ..config import UniMoEAudioConfig

    cfg = UniMoEAudioConfig.from_json(os.path.join(model_dir, "config.json"))
    params = convert_model_state_dict(load_hf_safetensors(model_dir), cfg)
    t_dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype

    def cast(x):
        if isinstance(x, dict):
            return {k: cast(v) for k, v in x.items()}
        if isinstance(x, list):
            return [cast(v) for v in x]
        return torch.from_numpy(np.ascontiguousarray(x)).to(t_dtype)

    def encode(x):
        if isinstance(x, dict):
            return {k: encode(v) for k, v in x.items()}
        if isinstance(x, list):
            return [encode(v) for v in x]
        if x.dtype == torch.bfloat16:
            return {"__bf16__": x.view(torch.int16).numpy().view(np.uint16)}
        return x.numpy()

    params = cast(params)
    # The router gate stays f32 (after the cast, as in the JAX package).
    params["layers"]["moe"]["gate"] = params["layers"]["moe"]["gate"].float()
    with open(out_path, "wb") as f:
        pickle.dump({"params": encode(params), "config": cfg.to_dict()}, f, protocol=4)
