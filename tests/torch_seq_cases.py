"""Inputs of the port's sequence- and pipeline-parallel tests, shared by
the ranks (`tests/torch_seq_worker.py`) and the test process
(`tests/test_torch_seq_parallel.py`), which builds the JAX and
single-device references from the same numbers.  Imports no JAX."""

import functools

import numpy as np

from tests import torch_mesh_cases as M
from unimoe_audio_torch.config import tiny_test_config

WORLD = 4
# Ring attention: (B, H, KV, T, pad) as tests/test_ring_attention.py, Dh 32.
RING_SHAPES = [(2, 4, 2, 64, 0), (1, 8, 2, 128, 5)]
RING_DH = 32
# The ring in the stack: tests/test_ring_attention.py's sizes.
STACK_B, STACK_T = 2, 64
LOSS_B, LOSS_T = 2, 16
# Trainer(ring_axis=...): (mesh, axis, fsdp, rows); rows None: the whole
# train batch of 4, split over (data, expert); 3 rows on (2, 2, 1) do not
# divide and run whole on every rank (the ring's same-rows branch).
RING_TRAIN_CASES = [((1, 1, 4), "model", False, None), ((2, 1, 2), "model", False, None),
                    ((2, 1, 2), "data", False, None), ((1, 2, 2), "expert", False, None),
                    ((4, 1, 1), "data", True, None), ((2, 2, 1), "data", False, 3)]
# The cases held to JAX's Trainer with the same ring axis on the same mesh.
RING_JAX_CASES = [c for c in RING_TRAIN_CASES if c[1] in ("data", "expert") and c[3] is None
                  and not c[2]]
# comm.rows_to_chunks / chunks_to_rows: (ranks, rows a rank, shape, seq dim).
EXCHANGE_CASES = [(4, 2, (8, 3), 1), (2, 3, (2, 6, 5), 2)]
SEQ_MESH = (2, 1, 2)
SEQ_B, SEQ_T = 2, 16
# tests/test_pipeline.py's cases: (stages, n_micro), 4 layers, T 6; one
# batch of 8 rows for all three (one compile of the JAX plain forward).
PIPE_CASES = [(2, 2), (4, 4), (2, 4)]
PIPE_LAYERS, PIPE_B, PIPE_T = 4, 8, 6
# A batch of 3 rows on a (2, 2, 1) mesh: replicated, as the JAX package does.
REPLICATED_MESH, REPLICATED_ROWS = (2, 2, 1), 3
DROP_POLICIES = ("probs", "position")
DROP_B, DROP_T = 4, 16


@functools.lru_cache(maxsize=None)
def ring_inputs(B, H, KV, T, pad):
    """q [B, H, T, Dh], k/v [B, KV, T, Dh], valid [B, T] (row 0 left-padded
    by pad) and the cotangent of the output [B, H, T, Dh]; f32."""
    rng = np.random.default_rng(T + pad)
    q = (rng.standard_normal((B, H, T, RING_DH)) * 0.4).astype(np.float32)
    k = (rng.standard_normal((B, KV, T, RING_DH)) * 0.4).astype(np.float32)
    v = rng.standard_normal((B, KV, T, RING_DH)).astype(np.float32)
    co = rng.standard_normal((B, H, T, RING_DH)).astype(np.float32)
    valid = np.ones((B, T), np.int32)
    valid[0, :pad] = 0
    return q, k, v, valid, co


def ring_case_id(case):
    """"1x1x4" for a model ring on the whole batch; else the axis, "fsdp"
    and the rows follow."""
    shape, axis, fsdp, rows = case
    parts = ["x".join(map(str, shape))] + ([] if axis == "model" else [axis])
    return "_".join(parts + (["fsdp"] if fsdp else []) + ([f"rows{rows}"] if rows else []))


@functools.lru_cache(maxsize=None)
def exchange_inputs(p, rows, shape, dim):
    """Every rank's rows x [p, rows, *shape] (f32; the sequence at `dim` of a
    rank's [rows, *shape]), an int32 mask [p, rows, T], the cotangents of the
    forward's outputs [p, p·rows, *shape with T/p] and of the reverse's
    outputs [p, rows, *shape]."""
    rng = np.random.default_rng(20 + p)
    T = shape[dim - 1]
    chunk = list(shape)
    chunk[dim - 1] = T // p
    x = rng.standard_normal((p, rows) + shape).astype(np.float32)
    mask = rng.integers(0, 2, size=(p, rows, T)).astype(np.int32)
    co = rng.standard_normal((p, p * rows) + tuple(chunk)).astype(np.float32)
    co_back = rng.standard_normal((p, rows) + shape).astype(np.float32)
    return x, mask, co, co_back


def stack_config(make=tiny_test_config, **kw):
    return make(**kw)


def hidden_inputs(cfg, B, T, seed=1):
    """Embeddings [B, T, D] (scaled 0.1) and text positions [3, B, T]."""
    D = cfg.text_config.hidden_size
    x = (np.random.default_rng(seed).standard_normal((B, T, D)) * 0.1).astype(np.float32)
    pos = np.broadcast_to(np.arange(T)[None, None], (3, B, T)).astype(np.int32)
    return x, np.ascontiguousarray(pos)


def pipe_cotangent(cfg):
    """The weights of the pipeline's scalar, sum(h · w) over its [B, T, D]
    output (sum(h²) of a final-norm output is nearly constant, and its
    small gradient mostly rounding)."""
    D = cfg.text_config.hidden_size
    return np.random.default_rng(11).standard_normal((PIPE_B, PIPE_T, D)).astype(np.float32)


def loss_config(make=tiny_test_config):
    """The tiny config with input jitter off (the frameworks draw different
    noise)."""
    return make(input_jitter_noise=0.0)


def loss_batch(cfg, B=LOSS_B, T=LOSS_T):
    """tests/test_ring_attention.py's train-step batch."""
    codec = np.random.default_rng(0).integers(0, cfg.codec_eos_value,
                                              size=(B, T, cfg.codec_channels)).astype(np.int32)
    return {"input_ids": np.full((B, T), cfg.codec_placeholder_value, np.int32),
            "codec_input_ids": codec, "attention_mask": np.ones((B, T), np.int32),
            "codec_labels": codec.copy()}


def pipe_config(make=tiny_test_config):
    return make(num_hidden_layers=PIPE_LAYERS)


def drop_config(policy, make=tiny_test_config):
    """token_drop on, with a capacity that cuts: 4 dynamic experts of the
    whole batch's 64 tokens keep at most 8 each."""
    return make(token_drop=True, drop_policy=policy, capacity_factor=0.5, min_capacity=1,
                input_jitter_noise=0.0)


def drop_inputs(cfg):
    D = cfg.text_config.hidden_size
    return (np.random.default_rng(7).standard_normal((DROP_B, DROP_T, D))).astype(np.float32)


def rebuild(tree, leaves):
    """tree's structure (dicts and lists, in their order) with `leaves` in
    place of its leaves, in `train.step.named_leaves` order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return next(it)

    return walk(tree)


train_config = M.train_config
port_params = M.port_params
trainer_config = M.trainer_config
train_batch = M.train_batch
two_steps = M.two_steps
