"""Self-speculative greedy decoding of the port
(`unimoe_audio_torch/generate/speculative.py`) on the CPU: f32, the tiny
2-layer config, the JAX package's weights through the bridge.  Codes and
lengths are held EQUAL (no tolerance) to the port's baseline
`generate(do_sample=False, decode_emit=False)` and to JAX's
`speculative_generate_jit`, for a full draft, a 1-layer draft and a short
chunk; with the int8 KV cache the codes equal the baseline's on that
cache; a full draft accepts every proposal; the draft's writes into the
live cache are never read; and `text_to_music_speculative` through the
API equals the API's greedy `text_to_music(decode_emit=False)` and the
JAX API's speculative call."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vt2m import stable_tokenizer
from unimoe_audio_torch.api import UniMoEAudio
from unimoe_audio_torch.codec import delay as dl
from unimoe_audio_torch.config import tiny_test_config
from unimoe_audio_torch.core.bridge import dac_params_from_jax, params_from_jax
from unimoe_audio_torch.generate import speculative as TS
from unimoe_audio_torch.generate.loop import generate, pad_buffer
from unimoe_audio_tpu import api as JAPI
from unimoe_audio_tpu.config import tiny_test_config as j_tiny_test_config
from unimoe_audio_tpu.generate.speculative import speculative_generate_jit
from unimoe_audio_tpu.models.model import init_model_params as j_init

MAX_TOKENS, MIN_TOKENS = 40, 4
KNOBS = dict(cfg_scale=3.0, eos_prob_mul_factor=0.8)


@pytest.fixture(scope="module")
def setup():
    jcfg = j_tiny_test_config()
    jp = j_init(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    cfg = tiny_test_config()
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    ids = np.random.default_rng(0).integers(1, 50, size=(2, 8)).astype(np.int32)
    mask = np.ones((2, 8), np.int32)
    prefill, steps = dl.prepare_audio_prompt(
        [None], num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    return cfg, jcfg, jp, tp, ids, mask, np.asarray(prefill), steps


def _port_args(setup):
    cfg, _, _, tp, ids, mask, prefill, steps = setup
    return (tp, cfg, torch.tensor(ids), torch.tensor(mask), None,
            pad_buffer(torch.tensor(prefill), MAX_TOKENS), steps)


def _baseline(setup, kv_dtype=None):
    tp, cfg, ids, mask, codec, buf, steps = _port_args(setup)
    return generate(tp, cfg, ids, mask, codec, buf, steps, torch.Generator(),
                    max_tokens=MAX_TOKENS, min_tokens=MIN_TOKENS, temperature=1.0, top_p=1.0,
                    cfg_filter_top_k=10, do_sample=False, decode_emit=False, kv_dtype=kv_dtype,
                    **KNOBS)


@pytest.mark.parametrize("draft_layers,spec_len", [(None, 4), (1, 4), (2, 3)])
def test_speculative_equals_baseline_and_jax(setup, draft_layers, spec_len):
    cfg, jcfg, jp, _, ids, mask, prefill, steps = setup
    n = draft_layers or cfg.text_config.num_hidden_layers
    spec = TS.speculative_generate(*_port_args(setup), max_tokens=MAX_TOKENS,
                                   min_tokens=MIN_TOKENS, spec_len=spec_len, draft_layers=n,
                                   **KNOBS)
    base = _baseline(setup)
    want = speculative_generate_jit(
        jp, jcfg, jnp.asarray(ids), jnp.asarray(mask), None,
        jnp.asarray(pad_buffer(torch.tensor(prefill), MAX_TOKENS).numpy()),
        jnp.asarray(steps, jnp.int32), max_tokens=MAX_TOKENS,
        min_tokens=jnp.int32(MIN_TOKENS), cfg_scale=jnp.float32(3.0),
        eos_prob_mul_factor=jnp.float32(0.8), spec_len=spec_len, draft_layers=n)
    assert int(spec.lengths[0]) > 0
    for ref in (base, want):
        np.testing.assert_array_equal(spec.codes.numpy(), np.asarray(ref.codes))
        np.testing.assert_array_equal(spec.lengths.numpy(), np.asarray(ref.lengths))
    assert spec.cycles == int(want.cycles) and spec.frames == int(want.frames)
    np.testing.assert_allclose(spec.accept_rate, float(want.accept_rate), rtol=1e-6)
    if draft_layers is None:
        assert spec.accept_rate > 0.99, spec.accept_rate


def test_speculative_int8_cache_equals_baseline(setup):
    """With the int8 KV cache the speculative decode equals the baseline
    loop on the same cache: the prefill is the loop's own, and the verify
    quantizes each frame's k/v as the loop's decode steps do (a 1-layer
    draft, so that proposals are rejected and their positions rewritten)."""
    spec = TS.speculative_generate(*_port_args(setup), max_tokens=MAX_TOKENS,
                                   min_tokens=MIN_TOKENS, spec_len=4, draft_layers=1,
                                   kv_dtype="int8", **KNOBS)
    assert spec.accept_rate < 0.99
    base = _baseline(setup, kv_dtype="int8")
    assert int(spec.lengths[0]) > 0
    np.testing.assert_array_equal(spec.codes.numpy(), base.codes.numpy())
    np.testing.assert_array_equal(spec.lengths.numpy(), base.lengths.numpy())


def test_draft_cache_writes_are_never_read(setup, monkeypatch):
    """The draft writes its layers' k/v into the live cache.  Poisoning
    every position it wrote (NaN in k and v, after each draft step) leaves
    the codes unchanged: the verify forward overwrites those positions in
    every layer before it attends."""
    cfg = setup[0]
    forward = TS.text_model_forward
    poisoned = []

    def poisoning(params, *a, **k):
        out = forward(params, *a, **k)
        if len(params["layers"]) < cfg.text_config.num_hidden_layers:     # a draft step
            pos, n = k["cache_position"], len(params["layers"])
            k["kv_cache"].k[:n, pos] = float("nan")
            k["kv_cache"].v[:n, pos] = float("nan")
            poisoned.append(pos)
        return out

    monkeypatch.setattr(TS, "text_model_forward", poisoning)
    spec = TS.speculative_generate(*_port_args(setup), max_tokens=MAX_TOKENS,
                                   min_tokens=MIN_TOKENS, spec_len=4, draft_layers=1, **KNOBS)
    assert len(poisoned) >= 3
    base = _baseline(setup)
    np.testing.assert_array_equal(spec.codes.numpy(), base.codes.numpy())
    np.testing.assert_array_equal(spec.lengths.numpy(), base.lengths.numpy())


def test_text_to_music_speculative_api(tmp_path):
    """The API call writes one wav whose codes equal the API's greedy
    `text_to_music(decode_emit=False)` and the JAX API's
    `text_to_music_speculative` (default draft: a quarter of the layers)."""
    jcfg = j_tiny_test_config()
    jm = JAPI.UniMoEAudio(allow_random=True, config=jcfg, dtype=jnp.float32, max_tokens=24,
                          min_tokens=4, tokenizer=stable_tokenizer(jcfg))
    tm = UniMoEAudio(allow_random=True, config=tiny_test_config(), device="cpu",
                     dtype=torch.float32, max_tokens=24, min_tokens=4, tokenizer=jm.tokenizer)
    tm.params = params_from_jax(jax.tree.map(np.asarray, jm.params), tm.config, "cpu")
    tm.dac.params = dac_params_from_jax(jax.tree.map(np.asarray, jm.dac.params), device="cpu")
    paths = tm.text_to_music_speculative("a calm piano piece", output_dir=str(tmp_path),
                                         spec_len=3)
    assert len(paths) == 1 and paths[0].endswith("generated_music_spec_0.wav")
    spec_codes, t = tm.last_codes[0], tm.last_timings
    assert t["cycles"] >= 1 and 0.0 <= t["accept_rate"] <= 1.0 and spec_codes.shape[0] > 0
    tm.text_to_music("a calm piano piece", output_dir=str(tmp_path), do_sample=False,
                     decode_emit=False)
    np.testing.assert_array_equal(spec_codes, tm.last_codes[0])

    def capture(codes, save_path, min_duration=None):
        captured.append(np.asarray(codes)[0].T)

    captured = []
    jm.dac.decode = capture
    try:
        jm.text_to_music_speculative("a calm piano piece", output_dir=str(tmp_path), spec_len=3)
    finally:
        del jm.dac.decode
    np.testing.assert_array_equal(spec_codes, captured[0])
