"""Shared arithmetic of the per-layer metric readers (`portbench/metrics/`)."""

import numpy as np


def trace(run):
    return run.layer.get("trace")


def window_span_s(run, name: str) -> float:
    """Seconds of the harness spans called `name` inside the window."""
    t0, t1 = run.layer["window_ns"]
    return sum(min(e, t1) - max(s, t0) for n, s, e in run.spans
               if n == name and e > t0 and s < t1) * 1e-9


def idle_share(run):
    tr = trace(run)
    if tr is None or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]


def padded_mask(mask, width: int) -> np.ndarray:
    """A request's [rows, T_req] attention mask in the server's t_text
    window (the request's tokens first, zeros after)."""
    m = np.asarray(mask)
    out = np.zeros((m.shape[0], width), np.int32)
    out[:, :m.shape[1]] = m
    return out
