"""Median device milliseconds of the window's `train.backward` spans: the
backward (`torch.autograd.grad`, remat's recompute inside), timed by the
CUDA events the span records."""

from harness import program


def read(run):
    return program.device_ms_p50(run, "train.backward")
