"""Operations and bytes of the port's hand-written attention kernels, from
their shapes: K1 (`flash_fwd_kernel`, the forward) and K2 + K3
(`flash_bwd_dq_kernel`, `flash_bwd_dkv_kernel` with the GQA sum
`flash_bwd_gqa_sum_kernel`, the backward).  Each input byte is counted
read once and each output byte written once; the products are those the
attended (query, key) pairs need: QK^T and PV forward, and in the backward
the five of S, dP, dV, dQ and dK (the recomputed S and dP the two
kernels share count once)."""

import numpy as np


def attended_pairs(valid: np.ndarray, T: int, causal: bool = True) -> int:
    """Pairs (row, query t, key s) with key s valid and s <= t (queries
    aligned to the keys' end): valid [B, S]."""
    valid = np.asarray(valid) > 0
    B, S = valid.shape
    if not causal:
        return int(valid.sum()) * T
    off = S - T
    # Query t sees keys s <= t + off: the count of valid keys in that prefix.
    prefix = np.concatenate([np.zeros((B, 1), np.int64), np.cumsum(valid, axis=1)], axis=1)
    idx = np.clip(np.arange(T) + off + 1, 0, S)
    return int(prefix[:, idx].sum())


def k1(B: int, H: int, KV: int, T: int, S: int, Dh: int, pairs: int):
    """(bytes, flops) of one K1 launch: q, k, v in and o out in bf16, the
    key mask int32, the softmax statistics m, l f32; 2 products of Dh per
    attended pair and head."""
    nbytes = (2 * B * H * T * Dh + 2 * B * KV * S * Dh) * 2 + B * S * 4 + 2 * B * H * T * 4
    return nbytes, 4 * Dh * H * pairs


def k2k3(B: int, H: int, KV: int, T: int, S: int, Dh: int, pairs: int):
    """(bytes, flops) of one backward (K2, K3 and the GQA sum together):
    q, k, v, do in and dq, dk, dv out in bf16; m, l and rowsum(do·o) f32;
    the key mask int32; 5 products of Dh per attended pair and head."""
    nbytes = (3 * B * H * T * Dh + 4 * B * KV * S * Dh) * 2 + 3 * B * H * T * 4 + B * S * 4
    return nbytes, 10 * Dh * H * pairs
