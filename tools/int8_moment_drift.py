"""int8 against f32 Adam moments: the second update's drift, on the CPU.

The JAX package's test (`tests/test_qmoment.py:98-133`) runs a
StreamTrainer with f32 moments and one with int8 moments from the same
parameters on the same batch: step 1 is bit-equal (zero moments), and
step 2 reads, per leaf, the largest element's move apart over the leaf's
largest f32 move.  This script makes that reading, and the per-leaf
relative L2 of the two second updates, for the JAX StreamTrainer and the
port's, from the same parameters and batches, at the flagship's widths
with NUM_LAYERS layer(s) and the text vocabulary cut to --vocab rows (the
layer leaves, where the reading peaks, keep their widths; the cut keeps
the run small on a CPU).  Input jitter is off; each implementation draws
its own mixer noise, the same for its two runs.

    python3 tools/int8_moment_drift.py [--impl jax,torch] [--vocab 4096]

prints one line per implementation with its worst leaves and one JSON line
with every leaf's two readings.  `--impl torch` alone imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NUM_LAYERS = 1
LR, WD, CLIP = 1e-4, 0.1, 1.0


def batches(cfg, B: int, T: int) -> list:
    """Two codec batches (placeholder rows, codec labels), from seeds 0, 1."""
    out = []
    for seed in range(2):
        codec = np.random.default_rng(seed).integers(
            0, cfg.codec_eos_value, size=(B, T, cfg.codec_channels)).astype(np.int32)
        out.append({"input_ids": np.full((B, T), cfg.codec_placeholder_value, np.int32),
                    "codec_input_ids": codec, "attention_mask": np.ones((B, T), np.int32),
                    "codec_labels": codec})
    return out


def readings(runs: dict) -> dict:
    """{leaf: (largest element error / largest f32 move, relative L2)} of
    the second updates, from {"float32": [p1, p2], "int8": [p1, p2]}, each
    a {name: numpy array}."""
    out = {}
    for n, p1 in runs["float32"][0].items():
        da = runs["float32"][1][n] - p1
        db = runs["int8"][1][n] - p1
        if not np.any(da):
            continue
        out[n] = (float(np.max(np.abs(db - da)) / max(float(np.max(np.abs(da))), 1e-12)),
                  float(np.linalg.norm(db - da) / np.linalg.norm(da)))
    return out


def run_torch(cfg, tree, data) -> dict:
    import torch

    from unimoe_audio_torch.core.bridge import params_from_jax
    from unimoe_audio_torch.train.step import named_leaves
    from unimoe_audio_torch.train.stream import StreamTrainer

    torch.manual_seed(0)
    out = {}
    for mom in ("float32", "int8"):
        st = StreamTrainer(cfg, params_from_jax(tree, cfg, "cpu"), learning_rate=LR,
                           weight_decay=WD, grad_clip=CLIP, train_lm_head=True,
                           moment_dtype=mom, device="cpu")
        snaps = []
        for b in data:
            st.train_step(b, 7)
            snaps.append({n: t.numpy().copy() for n, t in named_leaves(st.full_params())})
        st.close()
        out[mom] = snaps
    return out


def run_jax(jcfg, tree, data) -> dict:
    import jax
    import jax.numpy as jnp

    from unimoe_audio_tpu.train.stream import StreamTrainer

    out = {}
    for mom in ("float32", "int8"):
        st = StreamTrainer(jcfg, jax.tree.map(jnp.array, tree), learning_rate=LR,
                           weight_decay=WD, grad_clip=CLIP, train_lm_head=True,
                           moment_dtype=mom)
        snaps = []
        for b in data:
            st.train_step({k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(7))
            flat = jax.tree_util.tree_flatten_with_path(st.full_params())[0]
            snaps.append({jax.tree_util.keystr(p): np.asarray(x) for p, x in flat})
        out[mom] = snaps
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--impl", default="jax,torch")
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--B", type=int, default=2)
    ap.add_argument("--T", type=int, default=128)
    args = ap.parse_args()
    impls = args.impl.split(",")
    from unimoe_audio_torch.config import TextMoEConfig, UniMoEAudioConfig

    kw = dict(num_hidden_layers=NUM_LAYERS, vocab_size=args.vocab, input_jitter_noise=0.0)
    top = dict(vision_config=None, codec_placeholder_value=args.vocab - 1)
    cfg = UniMoEAudioConfig(text_config=dataclasses.replace(TextMoEConfig(), **kw), **top)
    data = batches(cfg, args.B, args.T)
    if "jax" in impls:
        import jax
        import jax.numpy as jnp

        from unimoe_audio_tpu import config as JC
        from unimoe_audio_tpu.models.model import init_model_params

        jax.config.update("jax_platforms", "cpu")
        jcfg = JC.UniMoEAudioConfig(text_config=dataclasses.replace(JC.TextMoEConfig(), **kw),
                                    **top)
        tree = jax.tree.map(np.asarray, init_model_params(jax.random.PRNGKey(0), jcfg,
                                                          dtype=jnp.float32))
    else:
        from unimoe_audio_torch.core.bridge import params_to_numpy
        from unimoe_audio_torch.models.model import init_model_params

        jcfg = None
        tree = params_to_numpy(init_model_params(cfg, seed=0, device="cpu"))
    result = {}
    for impl in impls:
        t0 = time.perf_counter()
        runs = run_jax(jcfg, tree, data) if impl == "jax" else run_torch(cfg, tree, data)
        r = readings(runs)
        result[impl] = r
        el = max(r.items(), key=lambda x: x[1][0])
        l2 = max(r.items(), key=lambda x: x[1][1])
        print(f"{impl}: {NUM_LAYERS} layer(s) at flagship width, vocab {args.vocab}, B {args.B} "
              f"x T {args.T}, f32 vs int8 moments, second update: largest element error over "
              f"the leaf's largest f32 move {el[1][0]:.3f} ({el[0]}); relative L2 per leaf at "
              f"most {l2[1][1]:.4f} ({l2[0]}); {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
