"""Generation of the PyTorch port vs the JAX package on the CPU.

Slice gate: on the tiny f32 model, greedy decoding through the port's
`generate` and `generate_chunked` (crossing chunk boundaries) gives codes
and lengths EQUAL to JAX `generate_jit`'s, with dense dispatch, with gmm
dispatch and with packed decode at a capacity.  Sampler: the bisection top-k
set equals JAX's bit for bit (ties included), and sampled draws follow the
renormalised softmax (torch and JAX generators differ, so sampling is
checked by distribution).  Delay helpers: numpy equality.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unimoe_audio_tpu.codec import delay as JD
from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.generate.loop import generate_jit, pad_buffer as j_pad_buffer
from unimoe_audio_tpu.generate.sampler import topk_threshold_bisect as j_bisect
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_torch.codec import delay as TD
from unimoe_audio_torch.core.bridge import params_from_jax
from unimoe_audio_torch.generate.loop import generate, generate_chunked, pad_buffer
from unimoe_audio_torch.generate.sampler import sample_next_token, topk_threshold_bisect

MAX_TOKENS = 20
KNOBS = dict(min_tokens=6, cfg_scale=3.0, temperature=1.0, top_p=1.0, cfg_filter_top_k=16,
             eos_prob_mul_factor=1.0)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    jp = JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    B, T = 2, 12
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.text_config.vocab_size - 8, size=(2 * B, T)).astype(np.int32)
    mask = np.ones((2 * B, T), np.int32)
    mask[0, :5] = 0          # left padding on a negative row
    mask[3, :2] = 0          # and on a conditional row
    prefill, steps = JD.prepare_audio_prompt(
        [None] * B, num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    want = generate_jit(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask), None,
        j_pad_buffer(prefill, MAX_TOKENS), jnp.asarray(steps, jnp.int32),
        jax.random.PRNGKey(0), max_tokens=MAX_TOKENS,
        min_tokens=jnp.int32(KNOBS["min_tokens"]), cfg_scale=jnp.float32(KNOBS["cfg_scale"]),
        temperature=jnp.float32(1.0), top_p=jnp.float32(1.0),
        cfg_filter_top_k=KNOBS["cfg_filter_top_k"], eos_prob_mul_factor=jnp.float32(1.0),
        do_sample=False)
    return cfg, tp, ids, mask, np.asarray(prefill), steps, want


@pytest.mark.parametrize("chunk_frames", [None, 8])
def test_greedy_codes_equal_jax(setup, chunk_frames):
    cfg, tp, ids, mask, prefill, steps, want = setup
    buf = pad_buffer(torch.tensor(prefill), MAX_TOKENS)
    gen = torch.Generator().manual_seed(0)
    args = (tp, cfg, torch.tensor(ids), torch.tensor(mask), None, buf, steps, gen)
    if chunk_frames is None:
        got = generate(*args, max_tokens=MAX_TOKENS, do_sample=False, **KNOBS)
    else:
        got, state = generate_chunked(*args, chunk_frames=chunk_frames, max_tokens=MAX_TOKENS,
                                      do_sample=False, return_state=True, **KNOBS)
        # The cache grew across at least one chunk boundary.
        assert state.cache.k.shape[1] > chunk_frames * 4
        assert got.steps > chunk_frames
    assert (np.asarray(want.lengths) > 0).all()
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.steps == int(want.steps)


def _jax_generate(setup, **kw):
    cfg, tp, ids, mask, prefill, steps, _ = setup
    return generate_jit(
        JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32), cfg,
        jnp.asarray(ids), jnp.asarray(mask), None, j_pad_buffer(jnp.asarray(prefill), MAX_TOKENS),
        jnp.asarray(steps, jnp.int32), jax.random.PRNGKey(0), max_tokens=MAX_TOKENS,
        min_tokens=jnp.int32(KNOBS["min_tokens"]), cfg_scale=jnp.float32(KNOBS["cfg_scale"]),
        temperature=jnp.float32(1.0), top_p=jnp.float32(1.0),
        cfg_filter_top_k=KNOBS["cfg_filter_top_k"], eos_prob_mul_factor=jnp.float32(1.0),
        do_sample=False, **kw)


@pytest.mark.parametrize("chunk_frames,kw", [
    (8, {"dispatch_mode": "gmm"}),
    (None, {"decode_dispatch_mode": "packed", "decode_capacity": 2}),
])
def test_greedy_codes_equal_jax_dispatch_modes(setup, chunk_frames, kw):
    """The slice gate through the other dispatch modes: greedy codes,
    lengths and steps equal JAX `generate_jit`'s with gmm in the prefill and
    every decode step (megablox in interpret mode there, the plain grouped
    products here; `generate_chunked` across chunk boundaries), and with
    packed decode at capacity 2 of the 4 rows (tokens are dropped)."""
    cfg, tp, ids, mask, prefill, steps, _ = setup
    want = _jax_generate(setup, **kw)
    buf = pad_buffer(torch.tensor(prefill), MAX_TOKENS)
    args = (tp, cfg, torch.tensor(ids), torch.tensor(mask), None, buf, steps,
            torch.Generator().manual_seed(0))
    if chunk_frames is None:
        got = generate(*args, max_tokens=MAX_TOKENS, do_sample=False, **KNOBS, **kw)
    else:
        got = generate_chunked(*args, chunk_frames=chunk_frames, max_tokens=MAX_TOKENS,
                               do_sample=False, **KNOBS, **kw)
    assert (np.asarray(want.lengths) > 0).all()
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.steps == int(want.steps)


def _guidance_labels(cfg, prefill, seed):
    """Delayed-domain labels [B, buf_len, C]: codes below EOS, about a
    tenth of them -1 (no label), and EOS on a later channel (not a valid
    target there) and on channel 0 (a valid one) at a few steps."""
    B, P, C = prefill.shape
    rng = np.random.default_rng(seed)
    eos = cfg.codec_eos_value
    lab = rng.integers(0, eos, size=(B, P + MAX_TOKENS, C)).astype(np.int32)
    lab[rng.random(lab.shape) < 0.1] = -1
    lab[0, 9, 2] = eos
    lab[1, 14, 0] = eos
    return lab


@pytest.mark.parametrize("debug_step,chunk_frames", [(-1, None), (-1, 8), (0, None), (7, None)])
def test_guidance_loss_equal_jax(setup, debug_step, chunk_frames):
    """The guidance branch: the teacher-forced CE of every step's gated
    CFG logits against the labels (channel 0 weighted 3x and allowed EOS),
    with the labels forced in as predictions for every step (-1), for the
    steps before 7, or for none (0): equal codes and lengths, the same
    count of valid labels, the loss within rtol 1e-5 of JAX
    `generate_jit(guidance_labels, debug_guidance_step)`'s, across chunk
    boundaries too."""
    cfg, tp, ids, mask, prefill, steps, _ = setup
    lab = _guidance_labels(cfg, prefill, seed=debug_step + 2)
    want = _jax_generate(setup, guidance_labels=jnp.asarray(lab),
                         debug_guidance_step=debug_step)
    buf = pad_buffer(torch.tensor(prefill), MAX_TOKENS)
    args = (tp, cfg, torch.tensor(ids), torch.tensor(mask), None, buf, steps,
            torch.Generator().manual_seed(0))
    kw = dict(max_tokens=MAX_TOKENS, do_sample=False, guidance_labels=torch.tensor(lab),
              debug_guidance_step=debug_step, **KNOBS)
    got = (generate(*args, **kw) if chunk_frames is None
           else generate_chunked(*args, chunk_frames=chunk_frames, **kw))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert int(got.guidance_count) > 0
    assert np.isfinite(float(got.guidance_loss))
    np.testing.assert_allclose(float(got.guidance_loss), float(want.guidance_loss), rtol=1e-5)
    no_labels = generate(*args, max_tokens=MAX_TOKENS, do_sample=False, **KNOBS)
    assert float(no_labels.guidance_loss) == 0.0 and int(no_labels.guidance_count) == 0


def test_decode_emit_false_equal_jax(setup):
    """decode_emit=False (the general cache arithmetic in every decode
    step) gives JAX's codes with the same switch, and the default path's."""
    cfg, tp, ids, mask, prefill, steps, default = setup
    want = _jax_generate(setup, decode_emit=False)
    got = generate(tp, cfg, torch.tensor(ids), torch.tensor(mask), None,
                   pad_buffer(torch.tensor(prefill), MAX_TOKENS), steps, torch.Generator(),
                   max_tokens=MAX_TOKENS, do_sample=False, decode_emit=False, **KNOBS)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(default.codes))


def _tied_logits(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((12, 97)).astype(np.float32)
    x[0, 10:20] = x[0, 5]                 # a run of exact ties
    x[1, :] = 1.0                         # all equal
    x[2, ::3] = -np.inf                   # suppressed tokens
    x[3, 40:] = -np.inf
    x[4] = np.round(x[4], 1)              # many ties at coarse resolution
    return x


@pytest.mark.parametrize("k", [1, 7, 16, 45])
@pytest.mark.parametrize("seed", [0, 1])
def test_bisection_topk_set_bit_identical(k, seed):
    x = _tied_logits(seed)
    want = np.asarray(j_bisect(jnp.asarray(x), k))
    got = topk_threshold_bisect(torch.tensor(x), k).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(x >= got, x >= want)


def _expected_probs(logits, temperature, top_p, K, eos):
    """The reference pipeline (tests/test_generate.py:235-258) in torch."""
    t = torch.tensor(logits) / temperature
    top_idx = t.argmax(-1)
    mask_eos = torch.zeros_like(t, dtype=torch.bool)
    mask_eos[top_idx != eos, eos] = True
    t = t.masked_fill(mask_eos, float("-inf"))
    kth = torch.topk(t, K, dim=-1).values[:, -1:]
    t = t.masked_fill(t < kth, float("-inf"))
    probs = torch.softmax(t, dim=-1)
    sp, si = torch.sort(probs, descending=True, dim=-1)
    rm = torch.roll(sp.cumsum(-1) > top_p, 1, dims=-1)
    rm[:, 0] = False
    t = t.masked_fill(torch.zeros_like(rm).scatter(-1, si, rm), float("-inf"))
    return torch.softmax(t, dim=-1).numpy()


@pytest.mark.parametrize("top_p,K", [(1.0, 12), (0.8, 12), (0.8, None)])
def test_sampler_distribution(top_p, K):
    """Draw frequencies vs the renormalised softmax: max |freq - p| < 0.02
    over 20000 draws per row (about 5 standard errors at p = 0.5); tokens
    outside the kept set are never drawn.  Row 0 has EOS on top (it may be
    drawn), the others do not (it never is).  K = None is the nucleus over
    the whole vocabulary (top_k >= V, as in the tiny configs)."""
    rng = np.random.default_rng(7)
    N, V, eos, R = 4, 50, 47, 20000
    logits = (rng.standard_normal((N, V)) * 2).astype(np.float32)
    logits[0, eos] = logits[0].max() + 0.5
    want = _expected_probs(logits, 0.9, top_p, V if K is None else K, eos)
    gen = torch.Generator().manual_seed(0)
    draws = sample_next_token(gen, torch.tensor(np.repeat(logits, R, axis=0)),
                              temperature=0.9, top_p=top_p, top_k=K,
                              audio_eos_value=eos).numpy().reshape(N, R)
    freq = np.stack([np.bincount(d, minlength=V) / R for d in draws])
    assert (freq[want == 0] == 0).all()
    assert np.abs(freq - want).max() < 0.02
    assert freq[0, eos] > 0 and (freq[1:, eos] == 0).all()


def test_decode_position_base_equals_jax():
    from unimoe_audio_tpu.generate.loop import decode_position_base as j_base
    from unimoe_audio_torch.generate.loop import decode_position_base as t_base

    lens = np.array([5, 12, 9, 12], np.int32)
    deltas = np.array([[-3], [0], [2], [-7]], np.int32)
    np.testing.assert_array_equal(t_base(torch.tensor(lens), 12).numpy(),
                                  np.asarray(j_base(jnp.asarray(lens), 12, None)))
    np.testing.assert_array_equal(t_base(torch.tensor(lens), 12, torch.tensor(deltas)).numpy(),
                                  np.asarray(j_base(jnp.asarray(lens), 12, jnp.asarray(deltas))))


def test_delay_helpers_equal_jax():
    rng = np.random.default_rng(3)
    delay = (0, 3, 4, 5)
    audio = rng.integers(0, 30, size=(2, 11, 4)).astype(np.int32)
    np.testing.assert_array_equal(
        TD.apply_audio_delay(audio, 37, 38, delay),
        np.asarray(JD.apply_audio_delay(jnp.asarray(audio), 37, 38, delay)))
    np.testing.assert_array_equal(
        TD.revert_audio_delay(audio, 37, delay),
        np.asarray(JD.revert_audio_delay(jnp.asarray(audio), 37, delay)))
    prompts = [None, rng.integers(0, 30, size=(4, 4))]
    tp, ts = TD.prepare_audio_prompt(prompts, num_channels=4, bos_value=38, delay_pattern=delay)
    jp, js = JD.prepare_audio_prompt(prompts, num_channels=4, bos_value=38, delay_pattern=delay)
    np.testing.assert_array_equal(tp, np.asarray(jp))
    assert ts == js
    lengths = np.array([5, 9])
    for a, b in zip(TD.generate_output(audio, lengths, pad_value=37, delay_pattern=delay),
                    JD.generate_output(jnp.asarray(audio), lengths, pad_value=37,
                                       delay_pattern=delay)):
        np.testing.assert_array_equal(a, b)
    codec = rng.integers(0, 30, size=(6, 4))
    kw = dict(delay_pattern=delay, num_channels=4, bos_value=38, eos_value=36, pad_value=37)
    np.testing.assert_array_equal(TD.preprocess_codec(codec, **kw),
                                  JD.preprocess_codec(codec, **kw))
