"""Share of the window's decode steps replayed from the decode step's CUDA
graph (`generate/decode_graph.py`): the program counter
`decode.graph_replays` over the window's `generate.decode_step` spans.  A
port without the decode graph reads None; one that has it but replayed
nothing in the window reads 0."""

from harness import program


def read(run):
    rec = program.record(run)
    steps = program.decode_steps(rec) if rec else []
    if not steps:
        return None
    try:
        from unimoe_audio_torch.generate import decode_graph  # noqa: F401
    except ImportError:
        return None
    return rec["counters"].get("decode.graph_replays", 0) / len(steps)
