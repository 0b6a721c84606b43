"""GPTQ int4 of the PyTorch port vs the JAX package, f32 on the CPU.

The inverse and the Cholesky factor of the Hessian come from other
libraries in the two frameworks (XLA and LAPACK through torch), and GPTQ
feeds each row's rounding error forward, so a last-bit difference can round
a later weight to the neighbouring level.  The port is held to the JAX
package's dequantized weights within GPTQ_REL_L2 relative L2 and with at
most GPTQ_Q_DIFF_FRAC of the int4 values different, and to the property
GPTQ exists for: on correlated inputs its output error ||XW - XŴ|| is below
round-to-nearest int4's (`tests/test_gptq.py:47`).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.ops import gptq as JG
from unimoe_audio_tpu.ops import quant as JQ
from unimoe_audio_torch.core.bridge import params_from_jax
from unimoe_audio_torch.ops import gptq as TG
from unimoe_audio_torch.ops import quant as TQ

GPTQ_REL_L2 = 2e-2
GPTQ_Q_DIFF_FRAC = 0.02


def _correlated(seed, N, D, rank):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, rank)) @ rng.standard_normal((rank, D))
    return (X + 0.05 * rng.standard_normal((N, D))).astype(np.float32)


def _close_to_jax(got: TQ.QTensor, want_q, want_s):
    gq = TQ.qvalues(got).numpy().astype(np.int32)
    wq = np.asarray(want_q).astype(np.int32)
    assert (gq != wq).mean() <= GPTQ_Q_DIFF_FRAC, (gq != wq).mean()
    deq = TQ.dequantize(got).numpy()
    jdeq = np.asarray(JQ.dequantize(JQ.QTensor(q=jnp.asarray(wq, jnp.int8), s=want_s)))
    assert np.linalg.norm(deq - jdeq) / np.linalg.norm(jdeq) < GPTQ_REL_L2


def test_cholesky_inv_upper_matches_jax():
    X = _correlated(0, 256, 64, 16)
    H = X.T @ X
    want = np.asarray(JG._cholesky_inv_upper(jnp.asarray(H)))
    got = TG._cholesky_inv_upper(torch.tensor(H)).numpy()
    assert np.allclose(np.tril(got, -1), 0)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("group_size", [0, 16])
def test_gptq_matches_jax_and_beats_rtn(group_size):
    D, F, N = 64, 48, 512
    X = _correlated(1, N, D, 8)
    W = np.random.default_rng(2).standard_normal((D, F)).astype(np.float32)
    H = X.T @ X
    got = TG.gptq_quantize_int4(torch.tensor(W), torch.tensor(H), group_size)
    jq, js = JG._gptq_int4_raw(jnp.asarray(W), jnp.asarray(H), group_size)
    assert got.s.dtype == torch.bfloat16 and tuple(got.s.shape) == js.shape
    assert tuple(got.s.shape) == ((1, F) if group_size == 0 else (D // group_size, F))
    _close_to_jax(got, jq, js)
    rtn = TQ.quantize_tensor_int4(torch.tensor(W), group_size)
    ref = X @ W
    e_gptq = np.sqrt(np.mean((X @ TQ.dequantize(got).numpy() - ref) ** 2))
    e_rtn = np.sqrt(np.mean((X @ TQ.dequantize(rtn).numpy() - ref) ** 2))
    assert e_gptq < 0.8 * e_rtn, (e_gptq, e_rtn)


def test_gptq_leading_dim_hessian_broadcast():
    """[L, E, D, F] weights with per-layer [L, D, D] Hessians: each matrix
    against its own layer's Hessian, as the JAX package does."""
    L, E, D, F = 2, 3, 32, 24
    W = np.random.default_rng(3).standard_normal((L, E, D, F)).astype(np.float32)
    H = np.stack([(lambda X: X.T @ X)(_correlated(10 + l, 256, D, 6)) for l in range(L)])
    q, s = TG._gptq_int4_raw(torch.tensor(W), torch.tensor(H), 0)
    jq, js = JG._gptq_int4_raw(jnp.asarray(W), jnp.asarray(H), 0)
    assert q.shape == W.shape and s.shape == (L, E, 1, F)
    _close_to_jax(TQ.QTensor(q=TQ.pack_int4(q), s=s), jq, js)
    one, _ = TG._gptq_int4_raw(torch.tensor(W[1, 2]), torch.tensor(H[1]), 0)
    assert torch.equal(one, q[1, 2])


@pytest.fixture(scope="module")
def model_setup():
    cfg = tiny_test_config()
    jp = JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.text_config.vocab_size - 8, size=(4, 24)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, :6] = 0
    return cfg, jp, ids, mask


def test_collect_moe_calibration_matches_jax(model_setup):
    cfg, jp, ids, mask = model_setup
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    want = JG.collect_moe_calibration(jp, cfg, jnp.asarray(ids),
                                      attention_mask=jnp.asarray(mask), max_calib_tokens=80)
    got = TG.collect_moe_calibration(tp, cfg, torch.tensor(ids),
                                     attention_mask=torch.tensor(mask), max_calib_tokens=80)
    assert got.shape == want.shape == (cfg.text_config.num_hidden_layers, 80,
                                       cfg.text_config.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    H = TG.collect_moe_hessians(tp, cfg, torch.tensor(ids), attention_mask=torch.tensor(mask))
    np.testing.assert_allclose(
        H.numpy(), np.asarray(JG.collect_moe_hessians(jp, cfg, jnp.asarray(ids),
                                                      attention_mask=jnp.asarray(mask))),
        rtol=1e-4, atol=1e-3)


def test_quantize_experts_int4_gptq_matches_jax(model_setup):
    """The whole-model expert conversion: F padded to 128, per-channel int4
    K-major experts close to JAX's, and each layer's gate output error on
    the calibration activations below round-to-nearest int4's."""
    cfg, jp, ids, mask = model_setup
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    X = TG.collect_moe_calibration(tp, cfg, torch.tensor(ids), attention_mask=torch.tensor(mask))
    orig = [{g: lp["moe"][g]["gate"].clone() for g in ("dynamic", "fixed")} for lp in tp["layers"]]
    TG.quantize_experts_int4_gptq(tp, cfg, torch.tensor(ids), attention_mask=torch.tensor(mask))
    want = JG.quantize_experts_int4_gptq(jax.tree.map(lambda a: a, jp), cfg, jnp.asarray(ids),
                                         attention_mask=jnp.asarray(mask))
    for l, lp in enumerate(tp["layers"]):
        for g in ("dynamic", "fixed"):
            for k in ("gate", "up", "down"):
                got = lp["moe"][g][k]
                w = want["layers"]["moe"][g][k]
                assert TQ.is_int4(got) and TQ.is_kmajor(got.q) and got.s.shape[-2] == 1
                assert TQ.wshape(got) == w.q.shape[1:]
                _close_to_jax(got, w.q[l].astype(jnp.int8), w.s[l])
            W = orig[l][g]
            Fn = W.shape[-1]
            rtn = TQ.quantize_tensor_int4(W)
            ref = X[l] @ W
            e_g = (X[l] @ TQ.dequantize(lp["moe"][g]["gate"])[..., :Fn] - ref).square().mean()
            e_r = (X[l] @ TQ.dequantize(rtn) - ref).square().mean()
            assert e_g < e_r, (l, g, float(e_g), float(e_r))
