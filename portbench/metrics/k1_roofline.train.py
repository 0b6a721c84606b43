"""K1 (`flash_fwd_kernel`) in the training window: launches x the least
time one launch needs at the training shape (B rows of T, causal, every
key valid) over their device time, in %."""

import numpy as np

from harness.readers import trace

from counts import flash
from harness import core, peaks


def read(run):
    tr = trace(run)
    if tr is None or "step_s" not in run.layer:
        return None
    n, secs = core.kernel_time(tr["events"], "flash_fwd_kernel")
    if n == 0 or secs <= 0:
        return None
    tc = run.layer["cfg"].text_config
    B, T = run.layer["B"], run.layer["T"]
    pairs = flash.attended_pairs(np.ones((B, T)), T)
    nbytes, flops = flash.k1(B, tc.num_attention_heads, tc.num_key_value_heads, T, T,
                             tc.head_dim, pairs)
    return 100.0 * n * peaks.bound_s(nbytes, flops) / secs
