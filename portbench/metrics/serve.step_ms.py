"""The window's milliseconds over the decode steps it ran: a time per
decode step taken over the whole window (admissions, retirement and DAC
decode included)."""


def read(run):
    steps = run.layer.get("steps")
    if "occupancy" not in run.layer or not steps:
        return None
    return 1e3 * run.layer["window_s"] / steps
