"""Sweep of chip_smoke's f32 VT2M prefill reference over hash salts.

The development tokenizer's word ids come from Python's salted `hash()`,
so each process feeds the 2-layer flagship-width VT2M prefill of
`chip_smoke.check_vt2m_reference` other token ids.  For each
PYTHONHASHSEED value this script builds that batch (the CFG pairs of
videos B and C of chip_smoke's VT2M run, in a child process under that
salt), runs the prefill on the card and on the CPU in f32, and prints one
JSON line:

- `own_rel_l2`: codec logits, card vs CPU, each run routing by its own
  router logits (the check as it stood before it shared the routing);
- `shared_rel_l2`: the same with the CPU fed the card's routing
  (`chip_smoke.router_tape`), and `router_rel_l2`, the router logits;
- `flips`: each live token that the two runs route otherwise, with its
  layer, which decision differs (top-p count, expert set, near-set cut)
  and that decision's margin on the CPU's logits: |cumsum - top_p| for
  the count, the logit gap at the cut for the set, |ratio - 2 eps| for
  the near-set;
- for a salt with a flip, a witness: the same prefill on the CPU in f64,
  its decisions at each flipped token (which run it sides with) and the
  codec logits' relative L2 of each f32 run against it.

Run from the repo root on a machine with a CUDA card:

    python3 tools/vt2m_router_sweep.py --salts 0-63 \\
        --out vt2m_router_sweep.jsonl
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402

ROWS = slice(2, 6)                     # the CFG pairs of videos B and C


def write_batch(path: str) -> None:
    """The VT2M batch of chip_smoke's run under this process's salt, as
    `UniMoEAudio.video_text_to_music` builds it (random-weight model's
    tokenizer, prompts, left-padded buckets, video slots, mRoPE
    positions): rows ROWS to an .npz."""
    from types import SimpleNamespace

    from unimoe_audio_torch.api import (SPECIAL_TOKENS, T2M_NEGATIVE_CAPTION, UniMoEAudio,
                                        vt2m_prompt)
    from unimoe_audio_torch.apps.video import video_to_patches
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.models.model import get_rope_index
    from unimoe_audio_torch.tokenizer import SimpleTokenizer

    cfg = UniMoEAudioConfig(text_config=TextMoEConfig())
    vcfg = cfg.vision_config
    special = {t: 100 + i for i, t in enumerate(SPECIAL_TOKENS)}
    special["<|AUDIO_PLACEHOLDER|>"] = cfg.codec_placeholder_value
    special["<|vision_start|>"] = cfg.vision_start_token_id
    special["<|vision_end|>"] = cfg.vision_end_token_id
    special["<|video_pad|>"] = cfg.video_token_id
    tok = SimpleTokenizer(vocab_size=min(cfg.text_config.vocab_size, 10000), special=special)
    texts, grids = [], []
    for v, n in zip(CS.vt2m_videos(), CS.VT2M_CAPTION_WORDS):
        _, grid = video_to_patches(v, patch_size=vcfg.patch_size,
                                   temporal_patch_size=vcfg.temporal_patch_size,
                                   merge_size=vcfg.spatial_merge_size)
        n_tok = int(np.prod(grid)) // vcfg.spatial_merge_size ** 2
        span = "<|vision_start|>" + "<|video_pad|>" * n_tok + "<|vision_end|>"
        for cap in (T2M_NEGATIVE_CAPTION, CS.caption(n)):
            texts.append(vt2m_prompt(span, cap))
            grids.append(grid)
    ids, mask = UniMoEAudio._tokenize(SimpleNamespace(tokenizer=tok), texts)
    pos, _ = get_rope_index(ids, cfg, video_grid_thw=np.stack(grids),
                            second_per_grid_ts=[vcfg.temporal_patch_size / 1] * len(texts),
                            attention_mask=mask)
    vmask = (ids == cfg.video_token_id).astype(np.int32)
    np.savez(path, ids=ids[ROWS], mask=mask[ROWS], visual_mask=vmask[ROWS],
             prefill_position_ids=np.asarray(pos)[:, ROWS])


def decisions(logits, tc):
    """The eval mixer's discrete decisions per token, from f32 or f64
    router logits [S, E]: (top-p count [S], expert-set mask [S, E],
    near-set include [S, E, E] over active rounds, the three margins [S]:
    |cumsum - top_p| nearest the threshold, the logit gap at the set's
    cut, |ratio - 2 eps| nearest the cut over active rounds)."""
    import torch

    x = logits.double()
    S, E = x.shape
    p = torch.softmax(x, -1)
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices
    csum = torch.cumsum(torch.gather(p, 1, order), -1)
    k = (csum < tc.mlp_dynamic_top_p).sum(-1) + 1
    m_count = (csum - tc.mlp_dynamic_top_p).abs().min(-1).values
    v = torch.gather(x, 1, order)
    idx = torch.arange(E)
    active = idx[None] < k[:, None]
    sets = torch.zeros(S, E, dtype=torch.bool).scatter_(1, order, active)
    last = torch.gather(v, 1, (k - 1)[:, None])[:, 0]
    nxt = torch.gather(v, 1, k.clamp(max=E - 1)[:, None])[:, 0]
    m_set = torch.where(k < E, last - nxt, torch.full_like(last, float("inf")))
    factor = torch.maximum(v.abs()[:, :, None], v.abs()[:, None, :])
    ratio = (v[:, :, None] - v[:, None, :]) / factor
    pair = (idx[None, None, :] > idx[None, :, None]) & active[:, :, None]
    include = pair & ~(ratio > 2 * tc.router_jitter_noise)
    gap = torch.where(pair, (ratio - 2 * tc.router_jitter_noise).abs(),
                      torch.full_like(ratio, float("inf")))
    m_near = gap.flatten(1).min(-1).values
    return k, sets, include, (m_count, m_set, m_near)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--salts", default="0-63", help="PYTHONHASHSEED values, e.g. 0-63 or 1,5,9")
    ap.add_argument("--out", default=None, help="also write the JSON lines to this file")
    ap.add_argument("--write-batch", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.write_batch:
        write_batch(args.write_batch)
        return

    import torch
    from unimoe_audio_torch.api import set_matmul_precision
    from unimoe_audio_torch.apps.video import video_to_patches
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.models import model as M
    from unimoe_audio_torch.models.layers import KVCache
    from unimoe_audio_torch.models.vision import init_vision_params, vision_forward

    if not torch.cuda.is_available():
        sys.exit("vt2m_router_sweep: needs a CUDA card")
    set_matmul_precision()
    salts = []
    for part in args.salts.split(","):
        a, _, b = part.partition("-")
        salts += list(range(int(a), int(b or a) + 1))
    t_start = time.perf_counter()
    tmp = tempfile.mkdtemp()

    def make(salt):
        path = os.path.join(tmp, f"{salt}.npz")
        subprocess.run([sys.executable, os.path.abspath(__file__), "--write-batch", path],
                       env={**os.environ, "PYTHONHASHSEED": str(salt)}, check=True)
        return salt, path

    with ThreadPoolExecutor(8) as pool:
        batches = dict(pool.map(make, salts))
    print(f"vt2m_router_sweep: {len(salts)} batches in {time.perf_counter() - t_start:.1f} s",
          flush=True)

    flag = UniMoEAudioConfig(text_config=TextMoEConfig())
    vcfg = dataclasses.replace(flag.vision_config, depth=CS.VT2M_REF_DEPTH)
    cfg = dataclasses.replace(flag, text_config=dataclasses.replace(flag.text_config,
                                                                    num_hidden_layers=2))
    tc = cfg.text_config
    tower = {"cuda": init_vision_params(vcfg, seed=5, dtype=torch.float32, device="cuda")}
    tower["cpu"] = CS._to(tower["cuda"], device="cpu")
    vids = dict(zip(CS.VT2M_VIDEOS, CS.vt2m_videos()))
    feats = {}
    with torch.inference_mode():
        for name in ("B", "C"):
            patches, grid = video_to_patches(vids[name])
            feats[name] = {dev: vision_forward(p, torch.as_tensor(patches, device=dev), grid[None],
                                               vcfg).float().cpu()
                           for dev, p in tower.items()}
    del tower
    params = {"cuda": M.init_model_params(cfg, seed=3, dtype=torch.float32, device="cuda")}
    params["cpu"] = CS._to(params["cuda"], device="cpu")
    params["f64"] = CS._to(params["cpu"], dtype=torch.float64)
    feats_f64 = {n: f["cpu"].double() for n, f in feats.items()}

    def run(kind, b, replay=None):
        device = "cuda" if kind == "cuda" else "cpu"
        dt = torch.float64 if kind == "f64" else torch.float32
        p = params[kind]
        t = lambda a, d=None: torch.as_tensor(a, dtype=d, device=device)   # noqa: E731
        ids, mask, vmask = b["ids"], b["mask"], b["visual_mask"]
        B, T = ids.shape
        emb = M.calculate_input_embedding(p, t(ids), None, cfg.codec_placeholder_value)
        visual = torch.zeros_like(emb)
        for r, name in enumerate("BBCC"):
            f = feats_f64[name] if kind == "f64" else feats[name][device]
            visual[r, t(np.flatnonzero(vmask[r]))] = f.to(device, dt)
        emb = torch.where(t(vmask)[..., None] > 0, visual, emb)
        cache = KVCache.create(tc.num_hidden_layers, B, T + 2, tc.num_key_value_heads,
                               tc.head_dim, dtype=dt, device=device)
        kv_valid = np.concatenate([mask, np.zeros((B, 2), mask.dtype)], -1)
        tape: list = []
        with CS.router_tape(tape, replay):
            out = M.text_model_forward(p, emb, t(b["prefill_position_ids"]), tc, kv_cache=cache,
                                       cache_position=0, kv_valid_mask=t(kv_valid, torch.int32),
                                       padding_token_mask=t(mask, torch.int32))
        live = torch.as_tensor(mask, dtype=torch.bool)
        return M.codec_logits_from_hidden(p, out.last_hidden_state, cfg).cpu()[live], tape

    lines = []
    for salt in salts:
        t0 = time.perf_counter()
        b = dict(np.load(batches[salt]))
        rows = torch.as_tensor(b["mask"], dtype=torch.bool).reshape(-1)
        with torch.inference_mode():
            card, card_tape = run("cuda", b)
            own, cpu_tape = run("cpu", b)
            shared, _ = run("cpu", b, replay=card_tape)
        rec = {"salt": salt, "ids_crc32": f"{zlib.crc32(b['ids'].astype(np.int64).tobytes()):08x}",
               "T": int(b["ids"].shape[1]), "live": int(rows.sum()),
               "own_rel_l2": CS._rel(card, own), "shared_rel_l2": CS._rel(card, shared),
               "router_rel_l2": max(CS._rel(a[rows], c[rows])
                                    for (a, _), (c, _) in zip(card_tape, cpu_tape)),
               "passes_own": CS._rel(card, own) < CS.VT2M_REF_REL_L2, "flips": []}
        for layer, ((lc, _), (lo, _)) in enumerate(zip(card_tape, cpu_tape)):
            dc, do = decisions(lc, tc), decisions(lo, tc)
            flip = CS.route_flips([card_tape[layer]], [cpu_tape[layer]], tc)[0] & rows
            for s in torch.nonzero(flip).flatten().tolist():
                kinds = [n for n, d in (("count", dc[0][s] != do[0][s]),
                                        ("set", (dc[1][s] != do[1][s]).any()),
                                        ("near", (dc[2][s] != do[2][s]).any())) if bool(d)]
                rec["flips"].append({
                    "layer": layer, "token": s, "kinds": kinds or ["weight"],
                    "margins_cpu": {"count": float(do[3][0][s]), "set": float(do[3][1][s]),
                                    "near": float(do[3][2][s])}})
        if rec["flips"]:
            with torch.inference_mode():
                ref, f64_tape = run("f64", b)
            rec["card_vs_f64"], rec["cpu_vs_f64"] = CS._rel(card, ref), CS._rel(own, ref)
            for f in rec["flips"]:
                s, layer = f["token"], f["layer"]
                d64 = decisions(f64_tape[layer][0], tc)
                dc = decisions(card_tape[layer][0], tc)
                do = decisions(cpu_tape[layer][0], tc)
                same = lambda d: bool(d[0][s] == d64[0][s] and (d[1][s] == d64[1][s]).all()  # noqa: E731
                                      and (d[2][s] == d64[2][s]).all())
                f["f64_sides_with"] = ("both" if same(dc) and same(do) else "card" if same(dc)
                                       else "cpu" if same(do) else "neither")
                f["margins_f64"] = {"count": float(d64[3][0][s]), "set": float(d64[3][1][s]),
                                    "near": float(d64[3][2][s])}
        rec["seconds"] = round(time.perf_counter() - t0, 2)
        line = json.dumps(rec)
        print(line, flush=True)
        lines.append(line)
    shutil.rmtree(tmp)
    fails = [json.loads(x)["salt"] for x in lines if not json.loads(x)["passes_own"]]
    print(f"vt2m_router_sweep: {len(salts)} salts, {len(fails)} fail the own-routing check "
          f"(limit {CS.VT2M_REF_REL_L2}): {fails}; shared routing worst "
          f"{max(json.loads(x)['shared_rel_l2'] for x in lines):.3e}; "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
