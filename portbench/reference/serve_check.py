"""The serving cell's check: greedy requests the window finished, run once
through the reference over their prompt and their served frames.

For each judged token (a code the model chose: below EOS, where the prompt
buffer was open) the reading is how far the served token's guided logit
lies below the reference's best at that position (both [neg, cond] rows
through the reference, combined by the request's CFG scale, over the
columns a greedy step may take before EOS is allowed: [0, eos)).  The
numbers compared are those of `readings` that the cell's limits name
(the widest gap, the mean gap); `short_tokens` counts how many judged
tokens the sample lacks of the limits' `min_judged_tokens`.

The reference's weights are made again from the seed (bf16, as the
program was handed them) once the program is freed; its quantized forms
are worked out again by the reference (`model.serve_layer_weights`).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from harness import weights

from . import model as M


def _rows(case, eos: int):
    """(rows, judged) of one request: its [neg, cond] rows' attended text
    ids and decode input frames, and the served codes [n, C] the logits at
    those inputs are judged against (-1 where not judged)."""
    req, res = case
    ps = int(req.prefill_steps)
    codes = np.asarray(res.codes)
    judged = np.where(codes < eos, codes, -1)
    n = int(np.nonzero((judged >= 0).any(axis=1))[0].max()) + 1 if (judged >= 0).any() else 0
    frames = np.concatenate([np.asarray(req.prefill)[ps - 1:ps], codes[:max(n - 1, 0)]], axis=0)
    ids, mask = np.asarray(req.input_ids), np.asarray(req.attention_mask)
    rows = [{"text": ids[r][mask[r] > 0], "frames": frames[:n]} for r in range(2)]
    return rows, judged[:n]


def logits_of(cfg, seed: int, dev, cases, lowp: Optional[str] = None,
              stats: Optional[Dict] = None) -> List[torch.Tensor]:
    """Guided logits [n, C, Vc] of each case at its decode inputs."""
    M.no_tf32()
    stacks = {k: weights.make_kind(cfg, seed, k, dev) for k in weights.KINDS
              if k != "lm_head"}

    def layer(i):
        return {k: stacks[k][i] for k in weights.KINDS if k not in weights.OUTER}

    eos = cfg.codec_eos_value
    rows: List = []
    for case in cases:
        rows += _rows(case, eos)[0]
    outer = {k: stacks[k] for k in ("embed_tokens", "codec_embed", "norm", "codec_head")}
    lg = M.serve_logits(layer, outer, cfg, rows, lowp=lowp, stats=stats)
    del stacks
    return [M.guided(lg[2 * j], lg[2 * j + 1], float(case[0].cfg_scale))
            for j, case in enumerate(cases)]


def gaps(cfg, cases, ref: List[torch.Tensor], pick: Optional[List[torch.Tensor]] = None
         ) -> torch.Tensor:
    """Every judged token's gap below the reference's best: the served
    token's, or with `pick` (the control's logits) that of the token `pick`
    puts first."""
    eos = cfg.codec_eos_value
    out = []
    for j, case in enumerate(cases):
        _, judged = _rows(case, eos)
        g = ref[j][..., :eos]
        tok = torch.as_tensor(judged, device=g.device).long()
        ok = tok >= 0
        if pick is not None:
            tok = torch.where(ok, pick[j][..., :eos].argmax(dim=-1), tok)
        got = torch.gather(g, -1, tok.clamp_min(0)[..., None])[..., 0]
        out.append((g.max(dim=-1).values - got)[ok])
    return torch.cat(out) if out else torch.zeros(0)


def readings(gap: torch.Tensor) -> Dict[str, float]:
    """The compared numbers of a set of gaps: the widest and the mean."""
    if gap.numel() == 0:
        return {"logit_gap_max": float("nan"), "logit_gap_mean": float("nan")}
    return {"logit_gap_max": float(gap.max()), "logit_gap_mean": float(gap.mean())}


def compare(run, cfg, cases, stats_out: Optional[Dict] = None) -> None:
    """Checks the numbers the cell's limits name, and how many judged
    tokens the sample lacks of `min_judged_tokens`."""
    need = int(run.limits["min_judged_tokens"])
    gap = torch.zeros(0)
    if cases:
        stats: Dict = {}
        ref = logits_of(cfg, run.seed, run.device, cases, stats=stats)
        gap = gaps(cfg, cases, ref)
        if stats_out is not None:
            stats_out["real_k"] = stats["real"] / stats["tokens"]
            stats_out["judged_tokens"] = int(gap.numel())
    for name, value in readings(gap).items():
        run.check(name, value)
    run.check("short_tokens", max(0, need - int(gap.numel())))
