"""Device-idle time inside the window's `generate.decode_step` spans (no
kernel, copy or memset of the device trace running) over their time."""

from harness import program
from harness.readers import trace


def read(run):
    rec, tr = program.record(run), trace(run)
    steps = program.decode_steps(rec) if rec else []
    if not steps or tr is None:
        return None
    iv = [(rec["spans"][i].t0_ns, rec["spans"][i].t1_ns) for i in steps]
    total = sum(b - a for a, b in iv)
    return float(program.idle_ns(tr["events"], iv).sum()) / total if total > 0 else None
