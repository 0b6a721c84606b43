"""DAC decoder of the PyTorch port vs the JAX package, f32 on the CPU
(atol 1e-4), through the weight bridge, plus the batched wav writer."""

import dataclasses
import wave

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unimoe_audio_tpu.codec import dac as JDAC
from unimoe_audio_torch.codec import dac as TDAC
from unimoe_audio_torch.codec.dac_wrapper import Dac
from unimoe_audio_torch.core.bridge import dac_params_from_jax


@pytest.fixture(scope="module")
def setup():
    cfg = JDAC.tiny_dac_config()
    jp = JDAC.init_dac_params(jax.random.PRNGKey(0), cfg)
    tp = dac_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def test_dac_decode_matches_jax(setup):
    cfg, jp, tp = setup
    codes = np.random.default_rng(0).integers(0, cfg.codebook_size,
                                              size=(2, cfg.n_codebooks, 13)).astype(np.int32)
    want = np.asarray(JDAC.dac_decode(jp, jnp.asarray(codes), cfg))
    tcfg = TDAC.DACConfig(**dataclasses.asdict(cfg))
    got = TDAC.dac_decode(tp, torch.tensor(codes), tcfg).numpy()
    assert got.shape == (2, 1, 13 * tcfg.hop_length)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_codes_past_the_codebook_are_clamped_as_in_jax(setup):
    """The default tiny model's codec vocab (39: EOS 36) lets codes 32-35
    reach the tiny DAC's 32-entry codebooks; the port clamps them as the
    JAX package's gather does, through `dac_decode` and the `Dac` wrapper."""
    from unimoe_audio_tpu.config import tiny_test_config

    cfg, jp, tp = setup
    vocab = tiny_test_config().codec_vocab_size
    codes = np.random.default_rng(4).integers(0, vocab - 3, size=(2, cfg.n_codebooks, 11))
    codes[0, :, :3] = [cfg.codebook_size, vocab - 4, cfg.codebook_size - 1]
    assert (codes >= cfg.codebook_size).any()
    want = np.asarray(JDAC.dac_decode(jp, jnp.asarray(codes, jnp.int32), cfg))
    tcfg = TDAC.DACConfig(**dataclasses.asdict(cfg))
    got = TDAC.dac_decode(tp, torch.tensor(codes), tcfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    dac = Dac(allow_random=True, config=tcfg, device="cpu")
    dac.params = tp
    np.testing.assert_allclose(dac.decode_array(codes[:1]), want[0], atol=1e-4, rtol=1e-4)


def test_decoder_block_pieces_match_jax(setup):
    """conv_transpose1d (stride 5: odd output padding) and snake alone."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 9)).astype(np.float32)
    w = rng.standard_normal((6, 4, 10)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(JDAC.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                            stride=5, padding=3, output_padding=1))
    got = TDAC.conv_transpose1d(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                                stride=5, padding=3, output_padding=1).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    alpha = rng.uniform(0.5, 2.0, size=(1, 6, 1)).astype(np.float32)
    np.testing.assert_allclose(TDAC.snake(torch.tensor(x), torch.tensor(alpha)).numpy(),
                               np.asarray(JDAC.snake(jnp.asarray(x), jnp.asarray(alpha))),
                               atol=1e-5, rtol=1e-5)


def test_dac_loads_converted_weights(setup):
    """The JAX package's DAC weights, converted through the bridge, decode
    through the Dac wrapper as the JAX decoder does."""
    cfg, jp, tp = setup
    dac = Dac(allow_random=True, config=TDAC.DACConfig(**dataclasses.asdict(cfg)), device="cpu")
    dac.params = tp
    assert dac.config.hop_length == cfg.hop_length
    codes = np.random.default_rng(3).integers(0, cfg.codebook_size, size=(1, cfg.n_codebooks, 9))
    want = np.asarray(JDAC.dac_decode(jp, jnp.asarray(codes), cfg))[0]
    np.testing.assert_allclose(dac.decode_array(codes), want, atol=1e-4, rtol=1e-4)


def test_decode_batch_writes_wavs(tmp_path):
    cfg = TDAC.tiny_dac_config()
    dac = Dac(allow_random=True, config=cfg, device="cpu")
    rng = np.random.default_rng(2)
    codes = [rng.integers(0, cfg.codebook_size, size=(cfg.n_codebooks, n)) for n in (7, 12)]
    paths = [str(tmp_path / f"{i}.wav") for i in range(2)]
    out = dac.decode_batch(codes, paths)
    for c, p, a in zip(codes, paths, out):
        with wave.open(p) as f:
            assert f.getnframes() == c.shape[1] * cfg.hop_length == a.shape[-1]
            assert f.getframerate() == cfg.sample_rate
    # The longest stream carries no padding: it decodes as it would alone.
    np.testing.assert_allclose(out[1], dac.decode_array(codes[1][None]), atol=1e-5)
