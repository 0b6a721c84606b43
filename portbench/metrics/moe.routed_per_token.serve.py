"""Real routed experts per token entering a DCMoE block in the window, from
the program's counters `moe.routed_experts` over `moe.routed_tokens`.  Every
row of the batch counts, parked slots' rows included, at decode steps and
admission prefills alike; null and fixed experts do not."""

from harness import program


def read(run):
    rec = program.record(run)
    c = rec["counters"] if rec else {}
    if not c.get("moe.routed_tokens"):
        return None
    return c.get("moe.routed_experts", 0) / c["moe.routed_tokens"]
