"""Configuration of the PyTorch port — its own copy of
`unimoe_audio_tpu/config.py`, so the port imports nothing of the JAX
package.  Same dataclasses, field names, defaults and `config.json`
reading.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class VisionConfig:
    """Qwen2.5-VL vision tower config (reference: utils/config.json:159-183)."""

    depth: int = 32
    hidden_size: int = 1280
    intermediate_size: int = 3420
    num_heads: int = 16
    in_channels: int = 3
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    spatial_patch_size: int = 14
    out_hidden_size: int = 2048
    window_size: int = 112
    fullatt_block_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    tokens_per_second: int = 2
    hidden_act: str = "silu"
    initializer_range: float = 0.02

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class TextMoEConfig:
    """Decoder/MoE config (reference: utils/UniMoE_Audio_model.py:66-120,
    values from utils/config.json:53-151)."""

    # Transformer core
    vocab_size: int = 151676
    hidden_size: int = 2048
    intermediate_size: int = 11008
    num_hidden_layers: int = 36
    num_attention_heads: int = 16
    num_key_value_heads: int = 2
    head_dim: Optional[int] = None  # defaults to hidden/heads
    hidden_act: str = "silu"
    rms_norm_eps: float = 1e-6
    max_position_embeddings: int = 128000
    rope_theta: float = 1_000_000.0
    mrope_section: Tuple[int, int, int] = (16, 24, 24)
    attention_dropout: float = 0.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    # Sliding-window attention (reference carries these through the HF mask
    # mapping, utils/UniMoE_Audio_model.py:370-383; the shipped checkpoint
    # uses full attention everywhere, utils/config.json:78-115,146).
    use_sliding_window: bool = False
    sliding_window: Optional[int] = None
    layer_types: Optional[Tuple[str, ...]] = None  # per-layer 'full_attention'/'sliding_attention'

    # DCMoE hyperparameters (reference: utils/UniMoE_Audio_core.py:202-234)
    mlp_dynamic_expert_num: int = 8
    mlp_dynamic_null_expert_num: int = 1
    mlp_dynamic_top_p: float = 0.7
    mlp_dynamic_top_k: int = 0
    mlp_fixed_expert_num: int = 2
    dynamic_intermediate_size: int = 2752
    shared_intermediate_size: int = 1376
    ignore_differentiable_router: bool = True
    router_jitter_noise: float = 0.01
    input_jitter_noise: float = 0.01
    token_drop: bool = False
    drop_policy: str = "probs"
    min_capacity: int = 8
    capacity_factor: float = 6.0
    fp32_gate: bool = True
    avg_hidden_states_last: bool = False
    l_aux_weight: float = 0.025
    min_l_aux_weight: float = 0.001
    l_aux_weight_decay_steps: int = 10000

    # Parallelism (mesh axis sizes; replaces DeepSpeed ep groups,
    # reference: utils/UniMoE_Audio_core.py:496-523)
    ep_size: int = 1

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.hidden_size // self.num_attention_heads)
        if isinstance(self.mrope_section, list):
            object.__setattr__(self, "mrope_section", tuple(self.mrope_section))
        if isinstance(self.mlp_dynamic_top_k, float):
            object.__setattr__(self, "mlp_dynamic_top_k", int(self.mlp_dynamic_top_k))
        if isinstance(self.layer_types, list):
            object.__setattr__(self, "layer_types", tuple(self.layer_types))

    @property
    def has_sliding_layers(self) -> bool:
        return bool(
            self.use_sliding_window
            and self.sliding_window
            and self.layer_types
            and "sliding_attention" in self.layer_types
        )

    @property
    def num_dynamic_experts(self) -> int:
        """Routed + null experts — the router's dynamic slice width
        (reference: utils/UniMoE_Audio_core.py:205)."""
        return self.mlp_dynamic_expert_num + self.mlp_dynamic_null_expert_num

    @property
    def num_experts(self) -> int:
        """Total router width: dynamic + null + fixed
        (reference: utils/UniMoE_Audio_core.py:211)."""
        return self.num_dynamic_experts + self.mlp_fixed_expert_num


@dataclass(frozen=True)
class UniMoEAudioConfig:
    """Top-level model config (reference: utils/UniMoE_Audio_model.py:123-163,
    values from utils/config.json:6-26)."""

    text_config: TextMoEConfig = field(default_factory=TextMoEConfig)
    vision_config: Optional[VisionConfig] = field(default_factory=VisionConfig)

    image_token_id: int = 151655
    video_token_id: int = 151656
    vision_start_token_id: int = 151652
    vision_end_token_id: int = 151653

    # Codec contract (reference: utils/config.json:6-26)
    codec_vocab_size: int = 1027
    codec_channels: int = 12
    codec_delay_pattern: Tuple[int, ...] = (0, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18)
    codec_eos_value: int = 1024
    codec_pad_value: int = 1025
    codec_bos_value: int = 1026
    codec_placeholder_value: int = 151665

    def __post_init__(self):
        if isinstance(self.text_config, dict):
            object.__setattr__(self, "text_config", TextMoEConfig(**self.text_config))
        if isinstance(self.vision_config, dict):
            object.__setattr__(self, "vision_config", VisionConfig(**self.vision_config))
        if isinstance(self.codec_delay_pattern, list):
            object.__setattr__(self, "codec_delay_pattern", tuple(self.codec_delay_pattern))

    @property
    def max_delay(self) -> int:
        return max(self.codec_delay_pattern)

    # The codec embedding tables and the codec head both span exactly
    # codec_vocab_size ids (eos/pad/bos specials included; reference:
    # utils/UniMoE_Audio_model.py:482-486 uses config.codec_vocab_size for
    # both, shipped value 1027 per utils/config.json:26).
    @property
    def codec_embed_size(self) -> int:
        return self.codec_vocab_size

    # ------------------------------------------------------------------
    # Serialization — interoperable with the reference's config.json layout.
    # ------------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["model_type"] = "uni_audio_rvq_qwen2_5vl_moe"
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "UniMoEAudioConfig":
        d = dict(d)
        d.pop("model_type", None)
        known = {f.name for f in dataclasses.fields(cls)}
        text = d.get("text_config") or {}
        if isinstance(text, dict):
            tknown = {f.name for f in dataclasses.fields(TextMoEConfig)}
            text = _remap_hf_text_config(text)
            d["text_config"] = TextMoEConfig(**{k: v for k, v in text.items() if k in tknown})
        vision = d.get("vision_config")
        if isinstance(vision, dict):
            vknown = {f.name for f in dataclasses.fields(VisionConfig)}
            d["vision_config"] = VisionConfig(**{k: v for k, v in vision.items() if k in vknown})
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, path: str) -> "UniMoEAudioConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, default=list)


def _remap_hf_text_config(text: Dict[str, Any]) -> Dict[str, Any]:
    """Map HF-style text_config fields (utils/config.json:53-151) onto
    TextMoEConfig field names."""
    text = dict(text)
    rope_scaling = text.pop("rope_scaling", None)
    if rope_scaling and "mrope_section" in rope_scaling:
        text["mrope_section"] = tuple(rope_scaling["mrope_section"])
    return text


def tiny_test_config(
    *,
    hidden_size: int = 64,
    num_hidden_layers: int = 2,
    num_attention_heads: int = 4,
    num_key_value_heads: int = 2,
    vocab_size: int = 256,
    mlp_dynamic_expert_num: int = 4,
    mlp_dynamic_null_expert_num: int = 1,
    mlp_fixed_expert_num: int = 2,
    dynamic_intermediate_size: int = 96,
    shared_intermediate_size: int = 48,
    codec_channels: int = 4,
    codec_vocab_size: int = 39,
    with_vision: bool = False,
    **text_overrides,
) -> UniMoEAudioConfig:
    """A miniature config for unit tests / CI — same structure, toy sizes."""
    text = TextMoEConfig(
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        intermediate_size=hidden_size * 4,
        num_hidden_layers=num_hidden_layers,
        num_attention_heads=num_attention_heads,
        num_key_value_heads=num_key_value_heads,
        mlp_dynamic_expert_num=mlp_dynamic_expert_num,
        mlp_dynamic_null_expert_num=mlp_dynamic_null_expert_num,
        mlp_fixed_expert_num=mlp_fixed_expert_num,
        dynamic_intermediate_size=dynamic_intermediate_size,
        shared_intermediate_size=shared_intermediate_size,
        max_position_embeddings=2048,
        **text_overrides,
    )
    vision = None
    if with_vision:
        vision = VisionConfig(
            depth=2,
            hidden_size=32,
            intermediate_size=64,
            num_heads=4,
            out_hidden_size=hidden_size,
            fullatt_block_indexes=(1,),
        )
    delay = tuple([0] + list(range(3, 3 + codec_channels - 1)))
    return UniMoEAudioConfig(
        text_config=text,
        vision_config=vision,
        codec_channels=codec_channels,
        codec_vocab_size=codec_vocab_size,
        codec_delay_pattern=delay,
        codec_eos_value=codec_vocab_size - 3,
        codec_pad_value=codec_vocab_size - 2,
        codec_bos_value=codec_vocab_size - 1,
        codec_placeholder_value=vocab_size - 1,
        vision_start_token_id=vocab_size - 2,
        vision_end_token_id=vocab_size - 3,
        video_token_id=vocab_size - 4,
        image_token_id=vocab_size - 5,
    )
