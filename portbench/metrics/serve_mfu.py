"""Model FLOPs of the window's decode steps and admission prefills over
window x 989 TFLOP/s, in %.  Decode: the active rows of each step (slots x
2 CFG rows x mean occupancy) at the mean attended keys (prompt + mean
progress of the slots); prefill: each admission's attended tokens.
Routed experts per token: the reference router's mean over the check's
tokens (the serving path reports no count of its own)."""

import numpy as np

from counts import model
from harness import peaks


def read(run):
    L = run.layer
    if "occupancy" not in L or "real_k" not in L or not L["steps"]:
        return None
    cfg, k = L["cfg"], L["real_k"]
    adm = L["admissions"]
    text = float(np.mean([np.asarray(m).sum(-1).mean() for m in adm])) if adm else 64.0
    rows = L["rows"] * float(np.mean(L["occupancy"]))
    flops = L["steps"] * rows * model.decode_row(cfg, k, text + L["mean_progress"])
    flops += sum(model.prefill(cfg, int(n), k) for m in adm for n in np.asarray(m).sum(-1))
    return 100.0 * flops / (L["window_s"] * peaks.PEAK_BF16_FLOPS)
