"""torch.cuda.max_memory_allocated() over the window, after a reset at its
start, in GB (1e9 bytes)."""


def read(run):
    b = run.layer.get("peak_bytes_window")
    return b / 1e9 if b else None
