"""The training cell's check: the reference follows the program's first
three steps from the same weights and batches, and three numbers compare
them.

  * loss_gap: max over the three steps of |loss - loss_ref| / |loss_ref|
    (loss_gap_first: the first step's);
  * grad_gap: the first gradient as the optimizer takes it, per leaf the
    norm of the first moment after step 1 ((1 - b1) · clip scale · g);
  * change_gap: per leaf the norm of the weights' change over the three
    steps;
  * grad_diff: per leaf the norm of the difference of the first moments
    after step 1 (the norms alone average the rounding of each element
    away: an fp8 step reads within 3 x of the bf16 program on them).
Leaf gaps are |norm - norm_ref| / max(norm_ref, the median leaf's norm_ref),
over the worst leaf (grad_gap, change_gap, grad_diff) and the median
leaf (the `_median` readings).  The cell's limits name those that
are compared.  Leaves whose reference gradient is under a thousandth
of the median leaf's (a key bias under softmax, embeddings the codec rows
never read) move by round-off alone and are left out of both.

The reference computes in float32 with TF32 off and keeps its weights and
moments in the configuration's storage types (bf16, the router f32), as
the optimizer of the configuration does: AdamW with optax's semantics
(global-norm clipping, bias correction, eps outside the root, the warmup
and cosine schedule), the update formed from the f32 moments before they
are stored.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from harness import weights

from . import model as M

OUTER = ("norm", "codec_embed", "codec_head")


def _tree(cfg, leaves: Dict[str, torch.Tensor], paths) -> Dict:
    """The reference's layout: per-layer dicts by kind, the outer leaves."""
    P = {"layers": [dict() for _ in range(cfg.text_config.num_hidden_layers)]}
    for p in paths:
        kind, i = weights.leaf_kind(p)
        t = leaves[weights.leaf_name(p)]
        if i < 0:
            P[kind] = t
        else:
            P["layers"][i][kind] = t
    return P


def _batch(batch_at, cfg, seed, step, B, T, dev, rows=None):
    b = batch_at(cfg, seed, step, B, T)
    sl = slice(None) if rows is None else slice(0, rows)
    return {k: torch.as_tensor(b[k][sl], device=dev) for k in ("codec_input_ids", "codec_labels")}


def follow(cfg, conf: Dict, seed: int, dev, batch_at, B: int, T: int, *,
           lowp: Optional[str] = None, rows: Optional[int] = None) -> Dict:
    """Three reference steps from the seed's weights on the seed's first
    three batches.  lowp: the control's precision; rows: use only the first
    `rows` rows of each batch (a fault of the check's own tests)."""
    M.no_tf32()
    t = conf["trainer"]
    tc = cfg.text_config
    b1, b2, eps = 0.9, 0.999, 1e-8
    params = weights.make_params(cfg, seed, dev, outer=OUTER)
    paths = [p for p, _ in weights.walk(params)]
    stored = {weights.leaf_name(p): leaf.clone() for p, leaf in weights.walk(params)}
    del params
    p0 = {k: v.clone() for k, v in stored.items()}
    m = {k: torch.zeros_like(v) for k, v in stored.items()}
    v_ = {k: torch.zeros_like(v) for k, v in stored.items()}
    out: Dict = {"losses": []}
    for step in range(3):
        batch = _batch(batch_at, cfg, seed, step, B, T, dev, rows)
        leaves = {k: s.to(torch.float32, copy=True).requires_grad_(True)
                  for k, s in stored.items()}
        aux_w = tc.l_aux_weight - (tc.l_aux_weight - tc.min_l_aux_weight) / \
            max(1, tc.l_aux_weight_decay_steps) * step
        loss = M.train_forward(_tree(cfg, leaves, paths), cfg, batch, step=step,
                               trainer_seed=seed, aux_weight=aux_w, lowp=lowp)
        names = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        out["losses"].append(float(loss.detach()))
        del leaves, loss
        with torch.no_grad():
            norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
            scale = 1.0 if float(norm) < t["grad_clip"] else t["grad_clip"] / norm
            lr = M.lr_at(step, t["learning_rate"], t["warmup_steps"], t["total_steps"])
            count = step + 1
            for k, g in zip(names, grads):
                g32 = g * scale
                m32 = m[k].float() * b1 + g32 * (1 - b1)
                v32 = v_[k].float() * b2 + (g32 * (1 - b2)) * g32
                u = (m32 / (1 - b1 ** count)) / ((v32 / (1 - b2 ** count)).sqrt() + eps)
                p32 = stored[k].float()
                if t["weight_decay"] and not any(s in k for s in ("norm", "/b")):
                    u = u + t["weight_decay"] * p32
                stored[k].copy_(p32 - lr * u)
                m[k].copy_(m32)
                v_[k].copy_(v32)
        del grads
        if step == 0:
            out["m1"] = {k: float(torch.linalg.vector_norm(x.float())) for k, x in m.items()}
            out["m1_t"] = {k: x.to("cpu", copy=True) for k, x in m.items()}
            out.update(M.routing_stats(_tree(cfg, {k: x.float() for k, x in p0.items()}, paths),
                                       cfg, batch, step=0, trainer_seed=seed))
    out["d3"] = {k: float(torch.linalg.vector_norm(stored[k].float() - p0[k].float()))
                 for k in stored}
    return out


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep) -> np.ndarray:
    """Per kept leaf |prog - ref| / max(ref, the median kept leaf's ref)."""
    names = [k for k in ref if keep(k)]
    med = float(np.median([ref[k] for k in names]))
    return np.array([abs(prog[k] - ref[k]) / max(ref[k], med) for k in names])


def diff_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], keep) -> np.ndarray:
    """Per kept leaf ||prog - ref|| / max(||ref||, the median kept leaf's)."""
    names = [k for k in ref if keep(k)]
    norms = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in names}
    med = float(np.median(list(norms.values())))
    return np.array([float(torch.linalg.vector_norm(prog[k].float() - ref[k].float()))
                     / max(norms[k], med) for k in names])


def readings(losses, m1, d3, ref: Dict, m1_t: Optional[Dict] = None) -> Dict[str, float]:
    """Every number the check can compare: the worst and the median leaf of
    each per-leaf gap of norms, the worst and the first step's loss gap,
    and with the program's first moments (`m1_t`) the worst and the median
    leaf of the norm of their difference from the reference's."""
    med_g = float(np.median(list(ref["m1"].values())))

    def moves(k):
        return ref["m1"][k] >= 1e-3 * med_g

    g, d = leaf_gaps(m1, ref["m1"], moves), leaf_gaps(d3, ref["d3"], moves)
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    out = {"loss_gap": max(loss), "loss_gap_first": loss[0],
           "grad_gap": float(g.max()), "grad_gap_median": float(np.median(g)),
           "change_gap": float(d.max()), "change_gap_median": float(np.median(d))}
    if m1_t is not None:
        x = diff_gaps(m1_t, ref["m1_t"], moves)
        out.update(grad_diff=float(x.max()), grad_diff_median=float(np.median(x)))
    return out


def compare(run, losses, m1, d3, ref: Dict, m1_t: Optional[Dict] = None) -> None:
    if len(losses) < 3 or any(not math.isfinite(x) for x in losses):
        for name in run.limits:
            run.check(name, float("nan"))
        return
    for name, value in readings(losses, m1, d3, ref, m1_t).items():
        run.check(name, value)
