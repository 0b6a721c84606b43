"""Share of the window spent in `slot.admit` spans (one request's
admission: its prefill and its splice into the live state)."""

from harness import program


def read(run):
    rec = program.record(run)
    admits = program.named(rec, "slot.admit") if rec else []
    if not admits:
        return None
    t0, t1 = run.layer["window_ns"]
    spans = [rec["spans"][i] for i in admits]
    return sum(min(s.t1_ns, t1) - max(s.t0_ns, t0) for s in spans) / (t1 - t0)
