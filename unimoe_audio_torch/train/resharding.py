"""Expert-parallel checkpoint tooling of the port — counterpart of
`unimoe_audio_tpu/train/resharding.py`:

  * aggregate_deepspeed_moe_checkpoint: a DeepSpeed MoE checkpoint
    directory (mp_rank_00_model_states.pt plus one file per (layer, expert),
    layer_{l}_expert_{e}_mp_rank_00_model_states.pt) read with torch.load
    into one flat state dict of numpy arrays with global expert ids, ready
    for `core/convert`;
  * split_expert_shards / merge_expert_shards: the port's dynamic experts
    (each layer's [E, ...] tensors) to and from ep_size per-rank lists of
    [E / ep, ...] tensors.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

import numpy as np
import torch


def _to_np(v) -> np.ndarray:
    """A tensor as numpy, integer and bool dtypes kept (step counters,
    masks); floating tensors as f32 (numpy has no bf16)."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v)
    if v.dtype.is_floating_point:
        return np.asarray(v.float().numpy())
    return np.asarray(v.numpy())


def aggregate_deepspeed_moe_checkpoint(ckpt_dir: str) -> Dict[str, np.ndarray]:
    """DeepSpeed MoE checkpoint directory → flat state dict with global
    expert ids (`resharding.py:26-77`).  Expert shard files hold keys like
    '...deepspeed_moe.experts.deepspeed_experts.{local_e}.<rest>'; the file
    name gives (layer, global expert), and the merged key takes the global
    id.  Two asserts catch a malformed shard: the layer in a key must be the
    file's, and no merged key may repeat."""
    blob = torch.load(os.path.join(ckpt_dir, "mp_rank_00_model_states.pt"), map_location="cpu",
                      weights_only=False)
    sd = blob.get("module", blob)
    merged = {k: _to_np(v) for k, v in sd.items()}

    pat = re.compile(r"layer_(\d+)_expert_(\d+)_mp_rank_00_model_states\.pt")
    for fname in sorted(os.listdir(ckpt_dir)):
        m = pat.match(fname)
        if not m:
            continue
        layer, global_e = int(m.group(1)), int(m.group(2))
        shard = torch.load(os.path.join(ckpt_dir, fname), map_location="cpu", weights_only=False)
        for k, v in shard.items():
            km = re.search(r"\.(\d+)\.deepspeed_moe\.", k)
            if km is not None:
                assert int(km.group(1)) == layer, (
                    f"{fname}: key layer {km.group(1)} != file layer {layer}")
            nk = re.sub(r"deepspeed_experts\.(\d+)\.", f"deepspeed_experts.{global_e}.", k)
            assert nk not in merged, (
                f"{fname}: duplicate target key {nk} — shard holds more than one local "
                "expert or repeats a global id")
            merged[nk] = _to_np(v)
    return merged


def split_expert_shards(params: Dict, ep_size: int) -> List[List[Dict[str, torch.Tensor]]]:
    """Each layer's dynamic experts [E, ...] → ep_size shards, each a list
    over the layers of {gate, up, down: [E / ep, ...]} (rank r holds experts
    [r·E/ep, (r+1)·E/ep)), as `split_expert_shards` in the JAX package
    (`resharding.py:80-95`) with its [L, E/ep, ...] leaves un-stacked."""
    dyns = [lp["moe"]["dynamic"] for lp in params["layers"]]
    E = next(iter(dyns[0].values())).shape[0]
    assert E % ep_size == 0, f"experts {E} not divisible by ep_size {ep_size}"
    per = E // ep_size
    return [[{k: v[r * per:(r + 1) * per].clone() for k, v in dyn.items()} for dyn in dyns]
            for r in range(ep_size)]


def merge_expert_shards(shards: List[List[Dict[str, torch.Tensor]]]) -> List[Dict[str, torch.Tensor]]:
    """Inverse of split_expert_shards: per layer, {gate, up, down: [E, ...]}
    (`resharding.py:98-99`)."""
    return [{k: torch.cat([s[l][k] for s in shards], dim=0) for k in shards[0][l]}
            for l in range(len(shards[0]))]
