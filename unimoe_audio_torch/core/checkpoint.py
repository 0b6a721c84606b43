"""Training checkpoints of the port: save, find and restore a `TrainState` —
counterpart of `unimoe_audio_tpu/core/checkpoint.py` (orbax there; the port
imports no JAX, so it keeps its own format).

Layout under `ckpt_dir`:

    <step>/state.pt    torch.save of {"names", "params", "mu", "nu", "acc",
                       "count", "mini_step", "step"}: the tensors as lists in
                       `named_leaves` order (acc None without gradient
                       accumulation), moved to the CPU
    meta_<step>.json   optional metadata sidecar

A step is written to a temporary directory and renamed into place, so a
crash never leaves a half-written step that `latest_step` would find.
After a save only the `max_to_keep` newest steps are kept, and the
sidecars of pruned steps go with them.  As orbax's manager does, a step at
or below the newest saved one is not written again.

`restore_checkpoint` loads with `torch.load(weights_only=True,
map_location="cpu")` and copies each tensor leaf by leaf into the state's
existing tensors (`copy_`), so the parameters keep `requires_grad` and
their device, and a state is never held on the card twice.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional

import torch

from ..train.step import TrainState, named_leaves

STATE_FILE = "state.pt"
_STEP_DIR = re.compile(r"\d+")
_META = re.compile(r"meta_(\d+)\.json")


def all_steps(ckpt_dir: str) -> List[int]:
    """The saved steps under ckpt_dir, ascending (a step counts once its
    directory holds the state file)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if _STEP_DIR.fullmatch(d)
                  and os.path.isfile(os.path.join(ckpt_dir, d, STATE_FILE)))


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _cpu(tensors) -> Optional[List[torch.Tensor]]:
    return None if tensors is None else [t.detach().cpu() for t in tensors]


def save_checkpoint(ckpt_dir: str, step: int, state: TrainState, *,
                    metadata: Optional[Dict] = None, max_to_keep: int = 3) -> bool:
    """Save `state` as `step`; True if it was written (False when a step at
    or above it is already saved).  Then write the metadata sidecar, if
    any, and prune to the max_to_keep newest steps."""
    os.makedirs(ckpt_dir, exist_ok=True)
    newest = latest_step(ckpt_dir)
    written = newest is None or step > newest
    if written:
        names, leaves = zip(*named_leaves(state.params))
        opt = state.opt_state
        blob = {"names": list(names), "params": _cpu(leaves), "mu": _cpu(opt.mu),
                "nu": _cpu(opt.nu), "acc": _cpu(opt.acc), "count": int(opt.count),
                "mini_step": int(opt.mini_step), "step": int(state.step)}
        tmp = os.path.join(ckpt_dir, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(blob, os.path.join(tmp, STATE_FILE))
        del blob
        os.replace(tmp, os.path.join(ckpt_dir, str(step)))
    if metadata is not None:
        with open(os.path.join(ckpt_dir, f"meta_{step}.json"), "w") as f:
            json.dump(metadata, f, indent=2, default=str)
    steps = all_steps(ckpt_dir)
    live = set(steps[-max_to_keep:]) if max_to_keep else set(steps)
    for s in steps:
        if s not in live:
            shutil.rmtree(os.path.join(ckpt_dir, str(s)), ignore_errors=True)
    for fname in os.listdir(ckpt_dir):
        m = _META.fullmatch(fname)
        if m and int(m.group(1)) not in live:
            try:
                os.remove(os.path.join(ckpt_dir, fname))
            except OSError:
                pass
    return written


@torch.no_grad()
def _copy_into(dst: List[torch.Tensor], src: List[torch.Tensor], what: str) -> None:
    if len(dst) != len(src):
        raise ValueError(f"checkpoint holds {len(src)} {what} tensors, the state {len(dst)}")
    for i, (d, s) in enumerate(zip(dst, src)):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"{what}[{i}]: checkpoint {tuple(s.shape)} {s.dtype}, state "
                             f"{tuple(d.shape)} {d.dtype}")
        d.copy_(s)


def restore_checkpoint(ckpt_dir: str, state: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """Load `step` (None: the latest) into `state` in place and return it:
    parameters, moments, the accumulator, the optimizer count, the
    mini-step and the step.  The checkpoint must hold the same leaves
    (names, shapes and dtypes) as the state."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    blob = torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE), weights_only=True,
                      map_location="cpu")
    names, leaves = zip(*named_leaves(state.params))
    if list(names) != blob["names"]:
        raise ValueError(f"checkpoint step {step} holds other parameters than the state")
    opt = state.opt_state
    if (blob["acc"] is None) != (opt.acc is None):
        raise ValueError("checkpoint and state differ in gradient accumulation "
                         f"(checkpoint acc {'absent' if blob['acc'] is None else 'present'})")
    _copy_into(list(leaves), blob["params"], "params")
    _copy_into(opt.mu, blob["mu"], "mu")
    _copy_into(opt.nu, blob["nu"], "nu")
    if opt.acc is not None:
        _copy_into(opt.acc, blob["acc"], "acc")
    opt.count, opt.mini_step = int(blob["count"]), int(blob["mini_step"])
    state.step = int(blob["step"])
    return state
