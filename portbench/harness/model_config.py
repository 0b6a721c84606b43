"""A configuration file's model as the port's config object.  The file's
`config` holds the text decoder's keys (`TextMoEConfig`'s names) beside
the codec contract's; the vision tower is not part of any configuration
here (`vision_config` None)."""

from __future__ import annotations

from typing import Dict

CODEC_KEYS = ("codec_vocab_size", "codec_channels", "codec_delay_pattern", "codec_eos_value",
              "codec_pad_value", "codec_bos_value", "codec_placeholder_value",
              "image_token_id", "video_token_id", "vision_start_token_id",
              "vision_end_token_id")


def build(conf: Dict):
    from unimoe_audio_torch.config import UniMoEAudioConfig

    c = dict(conf["config"])
    top = {k: c.pop(k) for k in CODEC_KEYS if k in c}
    return UniMoEAudioConfig.from_dict({"text_config": c, "vision_config": None, **top})
