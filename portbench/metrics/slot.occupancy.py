"""Mean share of the server's slots holding a request at each chunk
boundary of the window (`SlotServer.active`, read between `step()` calls)."""

import numpy as np


def read(run):
    occ = run.layer.get("occupancy")
    return float(np.mean(occ)) if occ else None
