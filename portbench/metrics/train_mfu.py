"""Model FLOPs of the window's training steps over window x 989 TFLOP/s
(bf16 dense peak), in %.  Each step counts forward x 3 (no remat
recompute) at its own routed experts per token: the trainer's
`mean_top_k` (null expert included) times the reference router's share
of real experts among its picks on the check's batch."""

from counts import model
from harness import peaks


def read(run):
    L = run.layer
    if "step_s" not in L or "real_share" not in L or not L.get("mean_top_k"):
        return None
    flops = sum(model.train_step(L["cfg"], L["B"], L["T"], k * L["real_share"])
                for k in L["mean_top_k"])
    return 100.0 * flops / (L["window_s"] * peaks.PEAK_BF16_FLOPS)
