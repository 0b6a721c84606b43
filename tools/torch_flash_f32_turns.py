"""Time the port's f32 flash-attention forward (K1 f32) of one source tree
on the card, beside SDPA in f32, and hash the outputs of the f32 kernels.

Run once per tree and in turns (parent, change, change, parent) within one
call on one card, so that two commits of the port are compared on the same
card:

    git archive <parent> | tar -x -C unimoe_audio_torch/_build/parent
    python3 tools/torch_flash_f32_turns.py --tree unimoe_audio_torch/_build/parent --label parent
    python3 tools/torch_flash_f32_turns.py --tree . --label change

The tree's own `chip_smoke.py` helpers time the calls (CUDA events over
back-to-back launches, and a CUDA graph of launches each after an L2
flush).  Shapes: a T2M-like prefill (B 8, T = S = 128, every other row
left-padded by 70 keys) and the training shape (B 4, T = S = 2048); H 16,
KV 2, Dh 128, causal.  The hashes are of K1's o, m, l and of K2 / K3's
dq, dk, dv at the training shape from the plain forward's residuals, so
that two trees with the same backward kernels give the same backward hash.
Prints one JSON line.  Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys


def _hash(tensors) -> str:
    return hashlib.sha256(b"".join(t.cpu().numpy().tobytes() for t in tensors)).hexdigest()[:16]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="root of the source tree to time")
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        sys.exit("torch_flash_f32_turns: no CUDA device")
    import chip_smoke as cs
    from unimoe_audio_torch.ops import flash_attention as FA

    H, KV, Dh = 16, 2, 128
    out = {"label": args.label, "tree": args.tree, "device": torch.cuda.get_device_name(0)}
    for B, T, seed, iters in ((8, 128, 5, 200), (4, 2048, 9, 20)):
        mask = np.ones((B, T), np.int32)
        if B == 8:
            mask[0::2, :70] = 0
        q, k, v, vt = cs.flash_inputs(B, H, KV, T, T, Dh, mask, seed, torch.float32)
        ms = cs.cuda_ms(lambda: FA.flash_attention(q, k, v, vt), iters)
        graph = cs.graph_ms(lambda: FA.flash_attention(q, k, v, vt), max(iters // 4, 10))
        kk, vv = (x.repeat_interleave(H // KV, dim=1) for x in (k, v))
        allowed = cs.allowed_mask(vt, T, T)[:, None]
        with torch.no_grad():
            sdpa_mask = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, attn_mask=allowed), iters)
            sdpa_causal = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, is_causal=True), iters)
        flops = 4 * Dh * int(cs.allowed_mask(vt, T, T).sum()) * H
        o, m, l = FA.flash_attention(q, k, v, vt, return_stats=True)
        rec = {"ms": ms, "graph_ms": graph, "sdpa_mask_ms": sdpa_mask,
               "sdpa_causal_ms": sdpa_causal, "tflops": flops / ms / 1e9,
               "fwd_hash": _hash((o, m, l))}
        if T == 2048:
            ro, rm, rl = FA.flash_attention_reference(q, k, v, vt, True, return_stats=True)
            rec.update(o_max_err=(o - ro).abs().max().item(),
                       o_rel_l2=((o - ro).norm() / ro.norm()).item())
            gen = torch.Generator(device="cuda").manual_seed(1)
            do = torch.randn(q.shape, generator=gen, device="cuda")
            bwd = (q, k, v, do, rm, rl, FA.softmax_residual_rowsum(do, ro), vt, True)
            rec["bwd_hash"] = _hash((FA.flash_attention_bwd_dq(*bwd),
                                     *FA.flash_attention_bwd_dkv(*bwd)))
        out[f"B{B}xT{T}"] = rec
    torch.cuda.synchronize()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
