"""Median training step in the window, host clock between steps (each
step ends in the trainer's own device synchronisation)."""

import numpy as np


def read(run):
    s = run.layer.get("step_s")
    return 1e3 * float(np.median(s)) if s else None
