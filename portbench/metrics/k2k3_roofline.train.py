"""The attention backward in the training window: K2
(`flash_bwd_dq_kernel`), K3 (`flash_bwd_dkv_kernel`) and the GQA sum
(`flash_bwd_gqa_sum_kernel`).  Backwards (K2 launches) x the least time
one needs at the training shape over the three kernels' device time, in %."""

import numpy as np

from harness.readers import trace

from counts import flash
from harness import core, peaks


def read(run):
    tr = trace(run)
    if tr is None or "step_s" not in run.layer:
        return None
    n, t_dq = core.kernel_time(tr["events"], "flash_bwd_dq_kernel")
    n3, t_dkv = core.kernel_time(tr["events"], "flash_bwd_dkv_kernel")
    _, t_sum = core.kernel_time(tr["events"], "flash_bwd_gqa_sum_kernel")
    if n == 0 or n3 != n:
        return None
    tc = run.layer["cfg"].text_config
    B, T = run.layer["B"], run.layer["T"]
    pairs = flash.attended_pairs(np.ones((B, T)), T)
    nbytes, flops = flash.k2k3(B, tc.num_attention_heads, tc.num_key_value_heads, T, T,
                               tc.head_dim, pairs)
    return 100.0 * n * peaks.bound_s(nbytes, flops) / (t_dq + t_dkv + t_sum)
