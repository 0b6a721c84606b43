"""Median `generate.decode_step` span of the window (the program's own:
one decode step's launches and the stop test after them), in ms."""

import numpy as np

from harness import program


def read(run):
    rec = program.record(run)
    steps = program.decode_steps(rec) if rec else []
    if not steps:
        return None
    return 1e-6 * float(np.median([program.length_ns(rec, i) for i in steps]))
