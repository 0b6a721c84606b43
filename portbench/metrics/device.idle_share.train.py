"""1 - (union of device activity) / traced window, training cells."""

from harness.readers import idle_share


def read(run):
    return idle_share(run) if "step_s" in run.layer else None
