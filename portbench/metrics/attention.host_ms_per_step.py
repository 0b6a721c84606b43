"""Host milliseconds in `model.attention` spans inside the window's decode
steps, over its decode steps."""

from harness import program


def read(run):
    return program.host_ms_per_decode_step(run, "model.attention")
