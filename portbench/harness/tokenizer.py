"""A deterministic word tokenizer with the surface the port's API calls
(`tok(texts, add_special_tokens=False, padding=True, return_tensors="np")`,
`pad_token_id`): whitespace words hashed by crc32 into the vocabulary, each
special token one id, left padding.  The repository holds no trained
tokenizer, and the port's development tokenizer hashes with Python's
salted `hash()`, which would give every process other ids: the inputs of
a run must follow from its seed alone."""

from __future__ import annotations

import re
import zlib
from typing import Dict, List

import numpy as np


class WordTokenizer:
    pad_token_id = 0

    def __init__(self, vocab_size: int, special: Dict[str, int]):
        self.vocab_size = vocab_size
        self.special = dict(special)
        self._split = re.compile("(" + "|".join(re.escape(t) for t in self.special) + ")")

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for part in self._split.split(text):
            if not part:
                continue
            if part in self.special:
                ids.append(self.special[part])
                continue
            ids += [10 + zlib.crc32(w.encode()) % (self.vocab_size - 20) for w in part.split()]
        return ids

    def __call__(self, text, add_special_tokens=False, padding=True, return_tensors="np"):
        texts = text if isinstance(text, list) else [text]
        seqs = [self.encode(t) for t in texts]
        T = max(len(s) for s in seqs)
        ids = np.zeros((len(seqs), T), np.int64)
        mask = np.zeros((len(seqs), T), np.int64)
        for i, s in enumerate(seqs):
            ids[i, T - len(s):] = s
            mask[i, T - len(s):] = 1
        return {"input_ids": ids, "attention_mask": mask}


def for_model(cfg, special_tokens: List[str]) -> WordTokenizer:
    """The tokenizer of a config: the API's special tokens at 100 + i, the
    codec placeholder and vision markers at the config's ids, words in the
    first 10,000 ids (as the port's development tokenizer)."""
    special = {t: 100 + i for i, t in enumerate(special_tokens)}
    special["<|AUDIO_PLACEHOLDER|>"] = cfg.codec_placeholder_value
    special["<|vision_start|>"] = cfg.vision_start_token_id
    special["<|vision_end|>"] = cfg.vision_end_token_id
    special["<|video_pad|>"] = cfg.video_token_id
    return WordTokenizer(min(cfg.text_config.vocab_size, 10000), special)
