"""Development tokenizer: a copy of `SimpleTokenizer`
(`unimoe_audio_tpu/train/data.py:303-351`), the hash-vocab whitespace
tokenizer used when no HF tokenizer assets exist.

Word ids come from Python's `hash()`, which is salted per process: the same
text gives other ids in another process.  Tests that compare the port with
the JAX package hand both the same token ids, not text.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

import numpy as np


class SimpleTokenizer:
    eos_token = "</s>"
    eos_token_id = 2
    bos_token_id = None
    pad_token_id = 0

    def __init__(self, vocab_size: int = 151676, special: Optional[Dict[str, int]] = None):
        self.vocab_size = vocab_size
        self.special = special or {}

    def _encode(self, text: str) -> List[int]:
        ids = []
        pattern = None
        if self.special:
            pattern = "(" + "|".join(re.escape(t) for t in self.special) + ")"
        parts = re.split(pattern, text) if pattern else [text]
        for part in parts:
            if not part:
                continue
            if part in self.special:
                ids.append(self.special[part])
                continue
            for w in part.split():
                ids.append(self.eos_token_id if w == self.eos_token
                           else 10 + (hash(w) % (self.vocab_size - 20)))
        return ids

    def __call__(self, text, add_special_tokens=False, padding=False, return_tensors=None):
        texts = text if isinstance(text, list) else [text]
        seqs = [self._encode(t) for t in texts]
        if return_tensors == "np":
            T = max(len(s) for s in seqs)
            ids = np.zeros((len(seqs), T), dtype=np.int64)
            mask = np.zeros((len(seqs), T), dtype=np.int64)
            for i, s in enumerate(seqs):
                ids[i, T - len(s):] = s
                mask[i, T - len(s):] = 1
            return {"input_ids": ids, "attention_mask": mask}

        class R:
            pass

        r = R()
        r.input_ids = seqs if isinstance(text, list) else seqs[0]
        return r
