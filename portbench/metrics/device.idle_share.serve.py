"""1 - (union of device activity) / traced window, serving cells."""

from harness.readers import idle_share


def read(run):
    return idle_share(run) if "occupancy" in run.layer else None
