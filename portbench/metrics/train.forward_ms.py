"""Median device milliseconds of the window's `train.forward` spans: the loss's
forward (`loss_fn`), timed by the CUDA events the span records."""

from harness import program


def read(run):
    return program.device_ms_p50(run, "train.forward")
