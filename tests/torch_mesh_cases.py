"""Inputs of the port's multi-process tests, shared by the ranks
(`tests/torch_mesh_worker.py`) and the test process
(`tests/test_torch_parallel.py`), which builds the single-device and JAX
references from the same numbers.  Imports no JAX."""

import functools
import os

import numpy as np
import torch

from unimoe_audio_torch.config import tiny_test_config
from unimoe_audio_torch.models.model import init_model_params
from unimoe_audio_torch.ops.quant import wshape

TRAIN_MESHES = [(2, 2, 1), (2, 1, 2), (1, 2, 2), (1, 1, 4)]
JITTER_MESH = (1, 2, 2)
FSDP_MESH = (2, 2, 1)
FSDP_MIN_BYTES = 1 << 10
EP_MESHES = [(2, 2, 1), (1, 4, 1)]
SERVE_FRAMES = 10
SERVE_CASES = {
    "f32": (False, None, torch.float32),
    "bf16": (False, None, torch.bfloat16),
    "int8": ("int8", None, torch.float32),
    "int4": ("int4", None, torch.float32),
    "int8_kv": ("int8", "int8", torch.float32),
}
# tests/test_parallel.py's sizes.
SIZES = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             mlp_dynamic_expert_num=4, dynamic_intermediate_size=64,
             shared_intermediate_size=32)


def train_config(jitter: bool = False, make=tiny_test_config):
    return make(**SIZES, **({} if jitter else {"input_jitter_noise": 0.0}))


def port_params(cfg):
    return init_model_params(cfg, seed=0, dtype=torch.float32, device="cpu")


def trainer_config():
    from unimoe_audio_torch.train.trainer import TrainerConfig

    # No warmup: both updates move the weights.
    return TrainerConfig(learning_rate=1e-3, total_steps=10, warmup_steps=0, log_every=1,
                         save_every=0)


def two_steps(trainer, cfg):
    """Two steps on `train_batch`: their metrics rows, and the whole params
    (numpy, JAX layout) after the first.  After one AdamW step a weight has
    moved by the rate times g / (|g| + eps): the same on every layout of the
    sums but where g is within rounding of 0; the second step's loss shows
    the update."""
    from unimoe_audio_torch.core.bridge import params_to_numpy

    def copy(tree):          # params_to_numpy shares the tensors' memory
        return {k: copy(v) for k, v in tree.items()} if isinstance(tree, dict) \
            else np.array(tree)

    first = trainer.fit([train_batch(cfg)], max_steps=1)
    params = copy(params_to_numpy(trainer.whole_params()))
    return first + trainer.fit([train_batch(cfg)]), params


def train_batch(cfg, B: int = 4, T: int = 8):
    """tests/test_parallel.py's make_batch."""
    rng = np.random.default_rng(0)
    C = cfg.codec_channels
    codec = rng.integers(0, cfg.codec_eos_value, size=(B, T, C)).astype(np.int32)
    labels = codec.copy()
    labels[:, :2] = -100
    return {"input_ids": np.full((B, T), cfg.codec_placeholder_value, np.int32),
            "codec_input_ids": codec, "attention_mask": np.ones((B, T), np.int32),
            "codec_labels": labels, "aux_balance_weight": np.ones((B, T), np.float32)}


@functools.lru_cache(maxsize=None)
def ep_inputs(S: int = 32, D: int = 16, E: int = 4, F: int = 8):
    """hidden [S, D], mask [S, E] int32, weights [S, E], params {gate, up
    [E, D, F], down [E, F, D]} (numpy, f32)."""
    rng = np.random.default_rng(3)
    h = rng.standard_normal((S, D)).astype(np.float32)
    mask = (rng.random((S, E)) < 0.5).astype(np.int32)
    w = rng.random((S, E)).astype(np.float32) * mask
    params = {"gate": rng.standard_normal((E, D, F)).astype(np.float32) * 0.3,
              "up": rng.standard_normal((E, D, F)).astype(np.float32) * 0.3,
              "down": rng.standard_normal((E, F, D)).astype(np.float32) * 0.3}
    return h, mask, w, params


def serve_config(make=tiny_test_config):
    return make(**SIZES)


GREEDY = dict(min_tokens=4, cfg_scale=3.0, temperature=1.0, top_p=1.0, cfg_filter_top_k=16,
              eos_prob_mul_factor=1.0)


def serve_inputs(cfg, B: int = 32, T: int = 16):
    """64 CFG rows of 16 tokens (packed dispatch in serving modes), the
    first row left-padded; the delayed prefill and its steps."""
    from unimoe_audio_torch.codec import delay as dl

    rng = np.random.default_rng(5)
    ids = rng.integers(0, cfg.text_config.vocab_size - 8, size=(2 * B, T)).astype(np.int32)
    mask = np.ones((2 * B, T), np.int32)
    mask[0, :3] = 0
    prefill, steps = dl.prepare_audio_prompt(
        [None] * B, num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    return ids, mask, np.asarray(prefill), steps


def greedy_codes(model) -> np.ndarray:
    """The model's greedy codes on `serve_inputs`, in its serving
    configuration."""
    from unimoe_audio_torch.generate.loop import generate, pad_buffer

    ids, mask, prefill, steps = serve_inputs(model.config)
    kw = {**model.serving_dispatch(*ids.shape), "kv_dtype": model.kv_cache_dtype}
    with torch.inference_mode():
        res = generate(model.params, model.config, torch.tensor(ids), torch.tensor(mask), None,
                       pad_buffer(torch.tensor(prefill), SERVE_FRAMES), steps,
                       torch.Generator(), max_tokens=SERVE_FRAMES, do_sample=False,
                       **GREEDY, **kw)
    return res.codes.numpy()


def prefill_logits(model) -> np.ndarray:
    """The codec logits of a forward over `serve_inputs`' tokens in the
    model's serving prefill dispatch, f32."""
    from unimoe_audio_torch.models.model import model_forward

    ids, mask, _, _ = serve_inputs(model.config)
    kw = model.serving_dispatch(*ids.shape)
    with torch.inference_mode():
        out = model_forward(model.params, model.config, torch.tensor(ids),
                            attention_mask=torch.tensor(mask),
                            dispatch_mode=kw.get("dispatch_mode", "dense"),
                            capacity=kw.get("prefill_capacity"))
    return out.codec_logits.float().numpy()


def wshape_of(w):
    return tuple(wshape(w))


def cli_paths(base: str):
    return os.path.join(base, "model"), os.path.join(base, "ds")


def cli_argv(base: str, out: str = None):
    """The training CLI's arguments on the text-only sample data set of 6
    rows: 2 steps of 2 rows, the last 2 rows held out for evaluation."""
    model, data = cli_paths(base)
    return ["--model_name_or_path", model, "--data_path", data,
            "--output_dir", out or os.path.join(base, "cli_out"),
            "--per_device_train_batch_size", "2", "--max_steps", "2", "--logging_steps", "1",
            "--save_steps", "0", "--model_max_length", "64", "--eval_ratio", "0.34",
            "--eval_steps", "1", "--learning_rate", "1e-3"]
