"""Median device milliseconds of the window's `train.optimizer` spans: the
optimizer (the gradient norm, the finite test's read and AdamW's update),
timed by the CUDA events the span records."""

from harness import program


def read(run):
    return program.device_ms_p50(run, "train.optimizer")
