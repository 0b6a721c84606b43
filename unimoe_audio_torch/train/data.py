"""Batch collation for training — the port's numpy copy of `Collator`
(`unimoe_audio_tpu/train/data.py:265-300`)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

IGNORE_INDEX = -100


@dataclass
class Collator:
    """Pad + mask + aux_balance_weight: right-pads input_ids with
    pad_token_id and labels with IGNORE_INDEX; the aux weight is 1
    everywhere and `aux_balance_weight` on label positions (output tokens
    get that emphasis in the balancing loss)."""

    pad_token_id: int
    aux_balance_weight: Optional[float] = None
    model_max_length: Optional[int] = None

    def __call__(self, instances: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
        T = max(len(x["input_ids"]) for x in instances)
        if self.model_max_length is not None:
            T = min(T, self.model_max_length)
        B = len(instances)
        input_ids = np.full((B, T), self.pad_token_id, dtype=np.int64)
        labels = np.full((B, T), IGNORE_INDEX, dtype=np.int64)
        for i, inst in enumerate(instances):
            n = min(len(inst["input_ids"]), T)
            input_ids[i, :n] = inst["input_ids"][:n]
            labels[i, :n] = inst["labels"][:n]
        batch = {
            "input_ids": input_ids,
            "labels": labels,
            "attention_mask": (input_ids != self.pad_token_id).astype(np.int64),
        }
        if self.aux_balance_weight is not None:
            abw = np.ones_like(input_ids, dtype=np.float32)
            abw[labels != IGNORE_INDEX] = self.aux_balance_weight
            batch["aux_balance_weight"] = abw
        for key in ("pixel_values", "image_grid_thw"):
            vals = [inst[key] for inst in instances if key in inst]
            if vals:
                batch[key] = np.concatenate(vals, axis=0)
        return batch
