"""Device operations (kernels, copies, memsets) in the traced window over
its decode steps."""

from harness.readers import trace


def read(run):
    tr, steps = trace(run), run.layer.get("steps")
    if tr is None or not steps or "occupancy" not in run.layer:
        return None
    return tr["n_events"] / steps
