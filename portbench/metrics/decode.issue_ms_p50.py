"""Median over the window's decode steps of a `generate.decode_step` span
less its `generate.stop_read` (the stop test's device-to-host read): the
host's time to issue one step, in ms."""

import numpy as np

from harness import program


def read(run):
    rec = program.record(run)
    steps = program.decode_steps(rec) if rec else []
    if not steps:
        return None
    kids = program.children(rec)
    return 1e-6 * float(np.median([program.self_ns(rec, i, kids, only="generate.stop_read")
                                   for i in steps]))
