"""Blockwise 8-bit moments of the PyTorch port (`train/qmoment.py`) vs the
JAX package's, on the same f32 inputs: round-to-nearest codes (equal on at
least 99.9 % of the elements, within one code elsewhere: f32 log2 and exp2
may differ by an ulp between XLA and torch), dequantized values within the
5.6 % half-step bound, zero exact and values below the floor clamped up,
`padded_len`; and the port's stochastic rounding (keyed by the counter
hash): each code floor(y) or floor(y) + 1, unbiased in the log domain over
many keys, equal keys equal codes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimoe_audio_tpu.train import qmoment as JQ
from unimoe_audio_torch.train import qmoment as TQ
from tests.torch_threads import one_torch_thread  # noqa: F401

EQUAL_SHARE = 0.999


def half_step(signed: bool) -> float:
    """The worst-case half-step relative error 2^(R / levels / 2) - 1 of the
    JAX module's docstring ("≈ 5.6 %": 126 levels over 20 octaves signed,
    254 over 40 unsigned), with 1e-5 of slack for f32 rounding."""
    octaves_per_level = TQ.R_SIGNED / 126 if signed else TQ.R_UNSIGNED / 254
    return 2.0 ** (octaves_per_level / 2) - 1 + 1e-5


def _inputs(signed: bool, seed: int, n_blocks: int = 4) -> np.ndarray:
    """Magnitudes log-uniform over 9 decades, a few exact zeros, and for
    the signed code random signs."""
    rng = np.random.default_rng(seed)
    x = np.exp(rng.uniform(np.log(1e-9), 0.0, n_blocks * TQ.BLOCK)).astype(np.float32)
    x[rng.integers(0, x.size, 20)] = 0.0
    if signed:
        x *= rng.choice([-1.0, 1.0], x.size).astype(np.float32)
    return x


@pytest.mark.parametrize("signed", [False, True])
def test_round_to_nearest_matches_jax(signed):
    x = _inputs(signed, seed=int(signed))
    jq, js = JQ.quantize_blockwise(jnp.asarray(x), signed=signed)
    tq, ts = TQ.quantize_blockwise(torch.from_numpy(x), signed=signed)
    jq, tq = np.asarray(jq).astype(int), tq.numpy().astype(int)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert np.mean(jq == tq) >= EQUAL_SHARE, np.mean(jq == tq)
    assert np.abs(jq - tq).max() <= 1
    back = TQ.dequantize_blockwise(torch.from_numpy(jq.astype(np.uint8)), ts, signed=signed)
    jback = JQ.dequantize_blockwise(jnp.asarray(jq.astype(np.uint8)), js, signed=signed)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=1e-6, atol=0)
    nz = x != 0
    rel = np.abs(back.numpy()[nz] - x[nz]) / np.abs(x[nz])
    floor = np.abs(x[nz]) < np.repeat(ts.numpy(), TQ.BLOCK)[nz] * 2.0 ** -(
        TQ.R_SIGNED if signed else TQ.R_UNSIGNED)
    assert rel[~floor].max() < half_step(signed), rel[~floor].max()
    assert np.all(back.numpy()[~nz] == 0.0)
    if signed:
        assert np.array_equal(np.sign(back.numpy()), np.sign(x))


def test_zero_exact_and_below_floor_clamps_up():
    x = np.zeros(TQ.BLOCK, np.float32)
    x[0], x[1] = 1.0, 1e-30
    q, s = TQ.quantize_blockwise(torch.from_numpy(x), signed=False)
    back = TQ.dequantize_blockwise(q, s, signed=False).numpy()
    assert back[0] == pytest.approx(1.0, rel=1e-6)
    assert np.all(back[2:] == 0.0)
    assert back[1] >= 2.0 ** -40 * 0.9
    q0, s0 = TQ.quantize_blockwise(torch.zeros(TQ.BLOCK), signed=True)
    assert int(q0.max()) == 0 and float(s0[0]) == 0.0
    assert torch.all(TQ.dequantize_blockwise(q0, s0, signed=True) == 0)


@pytest.mark.parametrize("n", [0, 1, 2047, 2048, 2049, 10 ** 6])
def test_padded_len_matches_jax(n):
    assert TQ.padded_len(n) == JQ.padded_len(n)


def _code_y(x: np.ndarray, signed: bool) -> np.ndarray:
    """The real-valued code position y that rounding turns into an integer
    (f64, per element; a positive signed value's offset is 128, a negative
    one's 1)."""
    xb = x.reshape(-1, TQ.BLOCK).astype(np.float64)
    amax = np.abs(xb).max(axis=1, keepdims=True)
    l = np.log2(np.maximum(np.abs(xb), 1e-38) / amax)
    if signed:
        t = np.clip(1.0 + l / TQ.R_SIGNED, 0, 1)
        return np.where(xb >= 0, 128.0 + 127.0 * t, 1.0 + 126.0 * t).reshape(-1)
    return (1.0 + 254.0 * np.clip(1.0 + l / TQ.R_UNSIGNED, 0, 1)).reshape(-1)


@pytest.mark.parametrize("signed", [False, True])
def test_stochastic_rounding(signed):
    x = _inputs(signed, seed=5, n_blocks=1)
    x[x == 0] = 1e-3
    xt = torch.from_numpy(x)
    y = _code_y(x, signed)
    codes = np.stack([TQ.quantize_blockwise(xt, signed=signed, key=TQ.rounding_key(step, 3))[0]
                      .numpy().astype(np.float64) for step in range(400)])
    # Each code is floor(y) or floor(y) + 1 (y within an ulp of an integer
    # may sit on either side of it in f32).
    lo = np.floor(y - 1e-4)
    assert np.all((codes >= lo) & (codes <= np.floor(y + 1e-4) + 1))
    # Unbiased in the log domain: the mean code over 400 keys is y, within
    # 5 standard errors of a Bernoulli(frac(y)) mean.
    frac = y - np.floor(y)
    se = np.sqrt(frac * (1 - frac) / codes.shape[0]) + 1e-3
    assert np.all(np.abs(codes.mean(axis=0) - y) <= 5 * se)
    # The codes really vary with the key, and equal keys give equal codes.
    assert np.mean(codes.std(axis=0) > 0) > 0.5
    a = TQ.quantize_blockwise(xt, signed=signed, key=TQ.rounding_key(9, 1))
    b = TQ.quantize_blockwise(xt.clone(), signed=signed, key=TQ.rounding_key(9, 1))
    c = TQ.quantize_blockwise(xt, signed=signed, key=TQ.rounding_key(9, 2))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("signed", [False, True])
def test_stochastic_rounding_keeps_the_top_code(signed):
    """At a block's absmax y is integral (254, or 127 and 126 signed); in
    f32 y + u rounds up to y + 1 for u within 2^-17 of 1 (18 of these 2^21
    draws), which must reach neither code 256 (torch's uint8 cast wraps it
    to 0: a nu stored as exact zero) nor, for a negative mu, code 128 (the
    positive floor)."""
    x = torch.ones(1 << 21)
    for sign, want in ((1.0, 255), (-1.0, 127 if signed else 255)):
        codes, scale = TQ.quantize_blockwise(sign * x, signed=signed, key=TQ.rounding_key(0, 0))
        assert torch.unique(codes).tolist() == [want]
        back = TQ.dequantize_blockwise(codes, scale, signed=signed)
        assert torch.equal(back, sign * x if signed else x)
