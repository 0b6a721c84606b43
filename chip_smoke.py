#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`unimoe_audio_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (H100,
sm_90a) and the CUDA toolkit.  Phases, each of which exits non-zero on
failure:

1. set-up: the card's name and power limit (nvidia-smi); the kernel
   unimoe_audio_torch/csrc/flash_attention_fwd.cu built with nvcc;
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the main path's shapes plus ragged and left-padded cases;
3. slice: the main path through the user's entry point,
   `UniMoEAudio.text_to_music`, at the full width of the flagship model
   (36 layers, hidden 2048, bf16, random weights from a seed) with the
   16 kHz DAC, on four captions long enough that the prompt buckets to
   128 tokens (so the prefill takes the flash kernel), through
   `generate_chunked`; the launch counters are zeroed just before it and
   read just after.  A small model's bf16 CUDA prefill is also held
   against its f32 CPU run;
4. timing of each kernel, its plain version and one PyTorch library call
   at the main path's shapes, with the least time the card could take.

The last lines of standard output are one JSON object describing every
kernel, then `{"ok": true, "device": {...}}`.  Without CUDA, or without
the package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

# Published peaks of an H100 SXM (NVIDIA data sheet): HBM3 bytes/s and
# dense bf16 tensor-core FLOP/s.  The bound of a kernel is the larger of
# its bytes over the first and its operations over the second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# Flash kernel vs plain version in bf16: both round P to bf16 at different
# points and accumulate in different orders.
FLASH_RTOL, FLASH_ATOL = 2e-2, 2e-2
STATS_RTOL, STATS_ATOL = 1e-2, 1e-2
# Small-model prefill vs its f32 CPU run, relative L2 error of the final
# hidden state over live rows: f32 on the card (TF32 off: summation order
# only), and bf16 on the card, whose rounding also flips a few router
# decisions (about 4e-2 through the plain bf16 path on the CPU); the flash
# path must be no less accurate than the einsum path, within 25 %.
PREFILL_F32_REL_L2 = 1e-3
PREFILL_BF16_REL_L2 = 1e-1
PREFILL_FLASH_VS_EINSUM = 1.25

WORDS = ("warm analog synth pads drift over a slow hip hop beat with dusty vinyl "
         "crackle mellow electric piano chords deep sub bass and soft brushed "
         "drums while a distant saxophone plays a lazy melody in a minor key").split()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def caption(n_words: int) -> str:
    return " ".join(WORDS[i % len(WORDS)] for i in range(n_words))


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn over iters launches, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_inputs(B, H, KV, T, S, Dh, valid, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, T, Dh, generator=gen, device="cuda").mul_(0.5).to(torch.bfloat16)
    k = torch.randn(B, KV, S, Dh, generator=gen, device="cuda").mul_(0.5).to(torch.bfloat16)
    v = torch.randn(B, KV, S, Dh, generator=gen, device="cuda").to(torch.bfloat16)
    return q, k, v, torch.as_tensor(valid, dtype=torch.int32, device="cuda").contiguous()


def allowed_mask(valid, T, S):
    import torch

    tri = torch.ones(T, S, dtype=torch.bool, device=valid.device).tril(S - T)
    return (valid[:, None, :] > 0) & tri                                  # [B, T, S]


def check_flash(B, H, KV, T, S, Dh, pads, seed) -> float:
    """Kernel vs plain version; dead rows exactly 0.  Returns max |err|."""
    import torch
    from unimoe_audio_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    valid = np.ones((B, S), np.int32)
    for b, p in enumerate(pads):
        valid[b, :p] = 0
    q, k, v, vt = flash_inputs(B, H, KV, T, S, Dh, valid, seed)
    o, m, l = flash_attention(q, k, v, vt, causal=True, return_stats=True)
    torch.cuda.synchronize()
    ro, rm, rl = flash_attention_reference(q, k, v, vt, True, return_stats=True)
    o32, r32 = o.float(), ro.float()
    name = f"flash B={B} H={H} KV={KV} T={T} S={S} Dh={Dh} pads={list(pads)}"
    check(bool(torch.isfinite(o32).all()), f"{name}: non-finite output")
    check(bool(((o32 - r32).abs() <= FLASH_ATOL + FLASH_RTOL * r32.abs()).all()),
          f"{name}: output differs from the plain version, max err "
          f"{(o32 - r32).abs().max().item()}")
    check(bool(((m - rm).abs() <= STATS_ATOL + STATS_RTOL * rm.abs()).all()), f"{name}: m differs")
    check(bool(((l - rl).abs() <= STATS_ATOL + STATS_RTOL * rl.abs()).all()), f"{name}: l differs")
    dead = ~allowed_mask(vt, T, S).any(-1)                                # [B, T]
    dead_rows = int(dead.sum()) * H
    check(bool((o32.abs().sum(-1)[dead[:, None, :].expand(B, H, T)] == 0).all()),
          f"{name}: a dead row is not exactly 0")
    err = (o32 - r32).abs().max().item()
    print(f"kernel check: {name}: max|err| {err:.3e} (rtol {FLASH_RTOL}, atol {FLASH_ATOL}); "
          f"{dead_rows} dead rows exactly 0", flush=True)
    return err


def check_small_prefill() -> None:
    """A 2-layer model with head_dim 128, one set of weights, held against
    its f32 prefill on the CPU (the path the parity tests hold against
    JAX): the f32 prefill on the card, and the bf16 prefill on the card
    through the flash kernel and through the einsum path.  Relative L2
    error of the final hidden state over live rows."""
    import torch
    from unimoe_audio_torch.config import tiny_test_config
    from unimoe_audio_torch.models import model as M
    from unimoe_audio_torch.models.layers import KVCache
    from unimoe_audio_torch.ops.flash_attention import flash_attention

    cfg = tiny_test_config(hidden_size=512, num_attention_heads=4, num_key_value_heads=2,
                           vocab_size=512)
    tc = cfg.text_config
    cpu = M.init_model_params(cfg, seed=1, dtype=torch.float32, device="cpu")

    def to(tree, **kw):
        if isinstance(tree, dict):
            return {k: to(v, **kw) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, **kw) for v in tree]
        return tree.to(**kw)

    B, T = 4, 128
    rng = np.random.default_rng(0)
    ids = rng.integers(0, tc.vocab_size - 8, size=(B, T))
    mask = np.ones((B, T), np.int64)
    for b, p in enumerate((0, 100, 17, 64)):
        mask[b, :p] = 0
    pos = np.where(mask == 0, 1, np.cumsum(mask, -1) - 1)
    live = torch.as_tensor(mask, dtype=torch.bool)

    def prefill(device, dtype, flash):
        params = cpu if device == "cpu" else to(cpu, device=device, dtype=dtype)
        ids_t = torch.as_tensor(ids, device=device)
        mask_t = torch.as_tensor(mask, dtype=torch.int32, device=device)
        pos_t = torch.as_tensor(pos, device=device)[None].expand(3, B, T)
        cache = KVCache.create(tc.num_hidden_layers, B, T, tc.num_key_value_heads, tc.head_dim,
                               dtype=dtype, device=device)
        emb = M.calculate_input_embedding(params, ids_t, None, cfg.codec_placeholder_value)
        out = M.text_model_forward(params, emb, pos_t, tc, kv_cache=cache, cache_position=0,
                                   kv_valid_mask=mask_t, padding_token_mask=mask_t,
                                   use_flash=flash)
        h = out.last_hidden_state.float().cpu()
        check(bool(torch.isfinite(h).all()), f"small prefill {device} {dtype}: non-finite")
        return h[live]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    with torch.inference_mode():
        ref = prefill("cpu", torch.float32, False)
        f32_err = rel(prefill("cuda", torch.float32, False), ref)
        einsum_err = rel(prefill("cuda", torch.bfloat16, False), ref)
        before = flash_attention.launches
        flash_err = rel(prefill("cuda", torch.bfloat16, True), ref)
        check(flash_attention.launches == before + tc.num_hidden_layers,
              "small prefill did not go through the flash kernel")
    check(f32_err < PREFILL_F32_REL_L2, f"f32 prefill, card vs CPU: relative L2 {f32_err}")
    check(flash_err < PREFILL_BF16_REL_L2 and flash_err <= PREFILL_FLASH_VS_EINSUM * einsum_err,
          f"bf16 prefill vs f32: flash {flash_err}, einsum {einsum_err}")
    print(f"reference check: 2-layer prefill vs f32 on the CPU, live rows, relative L2 error: "
          f"f32 card {f32_err:.3e} (limit {PREFILL_F32_REL_L2}); bf16 card through the flash "
          f"kernel {flash_err:.3e}, through the einsum path {einsum_err:.3e} (limits "
          f"{PREFILL_BF16_REL_L2}, and flash <= {PREFILL_FLASH_VS_EINSUM} x einsum)", flush=True)


def run_slice(card: str, out_dir: str):
    """The flagship text-to-music path, wavs into out_dir; returns
    (model, prompts, launch counts)."""
    import torch
    from unimoe_audio_torch.api import T2M_NEGATIVE_CAPTION, UniMoEAudio, t2m_prompt
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig
    from unimoe_audio_torch.ops.flash_attention import flash_attention

    cfg = UniMoEAudioConfig(text_config=TextMoEConfig(), vision_config=None)
    tc = cfg.text_config
    t0 = time.perf_counter()
    model = UniMoEAudio(allow_random=True, config=cfg, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(model.params))
    print(f"slice: flagship UniMoEAudio ({tc.num_hidden_layers} layers, hidden "
          f"{tc.hidden_size}, {n_params / 1e9:.2f} B params bf16) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    captions = [caption(n) for n in (58, 74, 90, 106)]
    # Warm-up: one short call (cuBLAS / cuDNN plans, allocator).
    model.text_to_music(captions, output_dir=out_dir, save_name="warmup", seed=1,
                        max_audio_seconds=1, min_audio_seconds=0.5)

    flash_attention.launches = 0
    paths = model.text_to_music(captions, output_dir=out_dir, seed=0,
                                max_audio_seconds=11, min_audio_seconds=6)
    launches = {"flash_attention_fwd": flash_attention.launches}
    t = model.last_timings
    codes = model.last_codes

    prefills = 1
    check(launches["flash_attention_fwd"] == tc.num_hidden_layers * prefills,
          f"flash launches {launches['flash_attention_fwd']} != "
          f"{tc.num_hidden_layers} x {prefills} prefill")
    check(t["steps"] > 256, f"decode took {t['steps']} steps: no chunk boundary crossed")
    check(len(paths) == len(captions), "one wav per caption")
    hop = model.dac.config.hop_length
    for p, n, c in zip(paths, t["lengths"], codes):
        check(os.path.isfile(p), f"missing wav {p}")
        check(c.shape == (n, cfg.codec_channels), f"codes shape {c.shape}")
        check(bool((c >= 0).all() and (c < model.dac.config.codebook_size).all()),
              "codes out of range")
        with wave.open(p) as f:
            n_samples = f.getnframes()
            pcm = np.frombuffer(f.readframes(n_samples), "<i2")
        check(n_samples == n * hop, f"{p}: {n_samples} samples != {n} frames x {hop}")
        check(int(np.abs(pcm).max()) > 0, f"{p}: silent")
    wav0 = model.dac.decode_array(codes[0].T[None])
    check(bool(np.isfinite(wav0).all()), "DAC output is not finite")

    audio_s = sum(t["lengths"]) / 50.0
    gen_s = t["prefill_s"] + t["decode_s"]
    print(f"slice: {len(captions)} requests (8 CFG rows), T_text 128, {t['steps']} decode steps, "
          f"frames {t['lengths']}; flash launches {launches['flash_attention_fwd']}", flush=True)
    print(f"slice: prefill {t['prefill_s'] * 1e3:.2f} ms; decode {t['decode_s'] * 1e3 / t['steps']:.2f} "
          f"ms/frame; aggregate realtime factor {audio_s / gen_s:.3f} "
          f"({audio_s:.2f} s of audio in {gen_s:.2f} s, prefill + decode); "
          f"DAC {t['dac_s'] * 1e3:.1f} ms  [{card}]", flush=True)
    neg = t2m_prompt(T2M_NEGATIVE_CAPTION)
    prompts = [x for c in captions for x in (neg, t2m_prompt(c))]
    return model, prompts, launches


def profile_short_call(model, prompts, card) -> None:
    """One short text-to-music call (30 frames) under torch.profiler:
    device kernel time against the host's wall time, kernel launches per
    decode step, the host's time blocked in device-to-host reads (the
    decode loop's per-step stop test), and the kernels that take the most
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as out_dir:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model._generate_core(*model._tokenize(prompts), "profile", out_dir,
                                 cfg_scale=10.0, seed=2, max_tokens=30, min_tokens=15)
    t = model.last_timings
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    wall_s = t["prefill_s"] + t["decode_s"] + t["dac_s"]
    if dev_us == 0:
        print("profile: torch.profiler recorded no device time: not measured", flush=True)
        return
    reads = [e for e in prof.key_averages() if e.key == "aten::_local_scalar_dense"]
    read_ms = sum(e.cpu_time_total for e in reads) / 1e3
    n_reads = sum(e.count for e in reads)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profile [{card}]: {len(prompts) // 2} requests, {t['steps']} decode steps, "
          f"prefill + decode + DAC {wall_s * 1e3:.1f} ms wall (profiled), device kernel time "
          f"{dev_us / 1e3:.1f} ms = {100 * dev_us / 1e3 / (wall_s * 1e3):.1f} % busy; "
          f"{launches} kernel launches, {launches / max(t['steps'], 1):.0f} per decode step; "
          f"host blocked in {n_reads} device-to-host reads for {read_ms:.2f} ms "
          f"({read_ms / max(t['steps'], 1):.3f} ms per decode step)", flush=True)
    for e in top:
        print(f"profile:   {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  {e.key[:90]}",
              flush=True)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def time_flash(model, prompts, launches, card):
    """Kernel, plain version and SDPA at the main path's prefill shape."""
    import torch
    import torch.nn.functional as F
    from unimoe_audio_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    tc = model.config.text_config
    _, mask = model._tokenize(prompts)                      # the main path's mask
    B, T = mask.shape
    H, KV, Dh = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    q, k, v, vt = flash_inputs(B, H, KV, T, T, Dh, mask, seed=5)
    err = check_flash(B, H, KV, T, T, Dh, [int((mask[b] == 0).sum()) for b in range(B)], seed=5)

    kk = k.repeat_interleave(H // KV, dim=1)
    vv = v.repeat_interleave(H // KV, dim=1)
    allowed = allowed_mask(vt, T, T)[:, None]                # [B, 1, T, S]
    count = flash_attention.launches
    ms = cuda_ms(lambda: flash_attention(q, k, v, vt), iters=200)
    flash_attention.launches = count                          # timing launches are not the path's
    plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, vt, True), iters=50)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, kk, vv, attn_mask=allowed),
                         iters=200)
    pairs = int(allowed_mask(vt, T, T).sum())                 # attended (query, key) pairs
    flops = 4 * Dh * H * pairs                                # QK^T and PV, 2 FLOP per MAC
    nbytes = (q.numel() + k.numel() + v.numel() + q.numel()) * 2 + vt.numel() * 4 \
        + 2 * B * H * T * 4                                   # q k v o bf16, mask, m l f32
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    rec = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "unimoe_audio_torch/csrc/flash_attention_fwd.cu",
        "replaces": "unimoe_audio_tpu/ops/flash_attention.py:30",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    print(f"kernel timing [{card}]: flash_attention_fwd B={B} H={H} KV={KV} T=S={T} Dh={Dh}: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
          f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} ({nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP)", flush=True)
    print(json.dumps({"kernel": rec}), flush=True)
    return rec


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from unimoe_audio_torch.api import set_matmul_precision
    from unimoe_audio_torch.ops import cuda_build

    set_matmul_precision()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    cuda_build.load("flash_attention_fwd")
    print(f"build: flash_attention_fwd built in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in cuda_build.build_logs["flash_attention_fwd"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: flash_attention_fwd: {line.strip()}", flush=True)

    check_flash(8, 16, 2, 128, 128, 128, (0,) * 8, seed=0)
    check_flash(8, 16, 2, 192, 192, 128, (0, 150, 3, 191, 64, 0, 100, 20), seed=1)
    check_flash(8, 16, 2, 128, 128, 128, (111, 40, 111, 0, 111, 70, 111, 5), seed=2)
    check_flash(2, 16, 2, 100, 160, 64, (7, 0), seed=3)
    check_small_prefill()

    with tempfile.TemporaryDirectory() as out_dir:
        model, prompts, launches = run_slice(card, out_dir)
    rec = time_flash(model, prompts, launches, card)
    profile_short_call(model, prompts, card)

    print(json.dumps({"kernels": [rec]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
