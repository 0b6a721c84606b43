"""K1 (`flash_fwd_kernel`) at the admission prefills of the window: the
least time the prefills' launches need (counts/flash.k1 at each request's
mask, one launch per layer) over their device time, in %."""

from harness.readers import padded_mask, trace

from counts import flash
from harness import core, peaks


def read(run):
    tr, adm = trace(run), run.layer.get("admissions")
    if tr is None or not adm:
        return None
    tc = run.layer["cfg"].text_config
    n, secs = core.kernel_time(tr["events"], "flash_fwd_kernel")
    if n != tc.num_hidden_layers * len(adm) or secs <= 0:
        return None
    T = run.layer["t_text"]
    H, KV, Dh = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    need = 0.0
    for mask in adm:
        m = padded_mask(mask, T)
        nbytes, flops = flash.k1(m.shape[0], H, KV, T, T, Dh, flash.attended_pairs(m, T))
        need += tc.num_hidden_layers * peaks.bound_s(nbytes, flops)
    return 100.0 * need / secs
