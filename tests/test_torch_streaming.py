"""Streaming generation of the PyTorch port vs the JAX package on the CPU
(tiny f32 model, greedy): the frames `generate_stream` yields, chunk after
chunk, concatenate to the frames of one `generate` call, and equal the
frames of the JAX package's `generate_stream`; with a Dac each chunk
carries its waveform.  `text_to_music_stream` drives it end to end."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.generate.streaming import generate_stream as j_generate_stream
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_torch.api import UniMoEAudio
from unimoe_audio_torch.codec import delay as TD
from unimoe_audio_torch.core.bridge import params_from_jax
from unimoe_audio_torch.generate.loop import generate, pad_buffer
from unimoe_audio_torch.generate.streaming import generate_stream
from tests.torch_threads import one_torch_thread  # noqa: F401

MAX_TOKENS = 40
KNOBS = dict(min_tokens=6, cfg_scale=3.0, temperature=1.0, top_p=1.0, cfg_filter_top_k=16,
             eos_prob_mul_factor=1.0, do_sample=False)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config()
    jp = JM.init_model_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, cfg.text_config.vocab_size - 8, size=(2, 14)).astype(np.int32)
    mask = np.ones((2, 14), np.int32)
    mask[0, :6] = 0                                    # the negative row is shorter
    return cfg, jp, tp, ids, mask


def _concat(chunks):
    return np.concatenate([c["frames"] for c in chunks], axis=1)


@pytest.mark.parametrize("chunk_frames", [7, 25])
def test_stream_equals_one_generate_and_jax(setup, chunk_frames):
    cfg, jp, tp, ids, mask = setup
    chunks = list(generate_stream(tp, cfg, ids, mask, None, torch.Generator().manual_seed(0),
                                  max_tokens=MAX_TOKENS, chunk_frames=chunk_frames, **KNOBS))
    assert chunks[-1]["done"] and not any(c["done"] for c in chunks[:-1])
    assert len(chunks) >= 2
    got = _concat(chunks)

    prefill, steps = TD.prepare_audio_prompt([None], num_channels=cfg.codec_channels,
                                             bos_value=cfg.codec_bos_value,
                                             delay_pattern=cfg.codec_delay_pattern)
    res = generate(tp, cfg, torch.tensor(ids), torch.tensor(mask), None,
                   pad_buffer(torch.tensor(prefill), MAX_TOKENS), steps, torch.Generator(),
                   max_tokens=MAX_TOKENS, **KNOBS)
    (one,) = TD.generate_output(res.codes.numpy(), res.lengths.numpy(),
                                pad_value=cfg.codec_pad_value,
                                delay_pattern=cfg.codec_delay_pattern)
    assert one.shape[0] > chunk_frames
    np.testing.assert_array_equal(got[0], one)
    assert int(chunks[-1]["lengths"][0]) == one.shape[0]

    want = _concat(j_generate_stream(jp, cfg, ids, mask, None, jax.random.PRNGKey(0),
                                     max_tokens=MAX_TOKENS, chunk_frames=chunk_frames, **KNOBS))
    np.testing.assert_array_equal(got, want)


def test_text_to_music_stream_yields_audio():
    m = UniMoEAudio(allow_random=True, device="cpu", dtype=torch.float32, max_tokens=30,
                    min_tokens=5)
    chunks = list(m.text_to_music_stream("calm piano", chunk_frames=8, seed=0))
    assert chunks[-1]["done"]
    hop = m.dac.config.hop_length
    for c in chunks:
        assert c["audio"].shape == (1, c["frames"].shape[1] * hop)
        assert np.isfinite(c["audio"]).all()
    assert sum(c["frames"].shape[1] for c in chunks) == int(chunks[-1]["lengths"][0]) > 0
