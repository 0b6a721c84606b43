"""Quantization and a8 expert compute of the PyTorch port vs the JAX package,
on the CPU with seeded numpy inputs:

  * int8 weights (`quantize_tensor`) and activations (`act_quant_int8`):
    q and s bit-equal; `quantize_model_params` over a tiny model too;
  * int4: the port's nibble packing round-trips every byte value (row- and
    K-major), and the clip-searched quantization (per-channel and
    group-wise, direct and requantized from int8) gives dequantized weights
    within 1e-3 relative L2 of JAX's, with at most 1 % of the scales
    different (near-ties of the clip search may sum in another order);
  * `pad_expert_ffn` over int8, int4 and group-wise QTensors: equal values;
  * the QTensor branches of `matmul` / `expert_einsum` (f32, 1e-5);
  * a8: the int32 products bit-equal (`torch._int_mm`, rows padded under
    17), the a8 FFN within 1e-6 relative in f32, through dense and packed
    dispatch (both strategies) and `dcmoe_block`; non-per-channel weights
    take the plain expression bit for bit;
  * `moe_ffn_gmm` over per-channel int8 and group-wise int4 QTensors,
    with and without an assignment budget, vs JAX's megablox gmm in
    interpret mode (f32, 1e-5).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.moe import block as JB
from unimoe_audio_tpu.moe import dispatch as JD
from unimoe_audio_tpu.ops import quant as JQ
from unimoe_audio_torch.core.bridge import params_from_jax, params_to_numpy
from unimoe_audio_torch.moe import block as TB
from unimoe_audio_torch.moe import dispatch as TD
from unimoe_audio_torch.ops import quant as TQ

INT4_REL_L2 = 1e-3
INT4_SCALE_DIFF_FRAC = 0.01
A8_REL = 1e-6
F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _jq(qt):
    """A port QTensor as the JAX package's (int4 values widened to int8)."""
    return JQ.QTensor(q=jnp.asarray(TQ.qvalues(qt).contiguous().numpy()),
                      s=jnp.asarray(qt.s.float().numpy()))


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tensor_bit_equal(dtype):
    w = (_rng(0).standard_normal((3, 64, 48)) * 0.02).astype(np.float32)
    w[1, :, 5] = 0.0                                   # an all-zero column: the 1e-8 floor
    want = JQ.quantize_tensor(jnp.asarray(w).astype(dtype))
    got = TQ.quantize_tensor(torch.tensor(w).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.s.numpy(), np.asarray(want.s))
    assert got.q.dtype == torch.int8 and got.s.shape == (3, 1, 48)


def test_act_quant_int8_bit_equal():
    x = _rng(1).standard_normal((4, 10, 64)).astype(np.float32) * 3
    x[1, 3] = 0.0                                      # a padding row quantizes to q = 0
    wq, ws = JQ.act_quant_int8(jnp.asarray(x))
    q, s = TQ.act_quant_int8(torch.tensor(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    assert (q[1, 3] == 0).all()


def test_int4_pack_round_trip_all_bytes():
    """Every byte value unpacks to its two sign-extended nibbles (low nibble
    = even column) and packs back; the same from a K-major tensor."""
    b = torch.arange(256, dtype=torch.int32).to(torch.uint8).reshape(16, 16)
    lo = np.arange(256) & 0xF
    hi = np.arange(256) >> 4
    want = np.stack([np.where(lo > 7, lo - 16, lo), np.where(hi > 7, hi - 16, hi)], -1)
    v = TQ.unpack_int4(b)
    np.testing.assert_array_equal(v.numpy().reshape(256, 2), want)
    assert v.dtype == torch.int8 and v.shape == (16, 32)
    assert torch.equal(TQ.pack_int4(v), b)
    vk = TQ.unpack_int4(TQ.kmajor(b))
    assert torch.equal(vk, v) and TQ.is_kmajor(vk)
    with pytest.raises(ValueError):
        TQ.pack_int4(torch.zeros(4, 3, dtype=torch.int8))


@pytest.mark.parametrize("shape,group_size", [((4, 256, 128), 0), ((4, 256, 128), 64),
                                              ((2, 3, 64, 96), 0), ((3, 512, 64), 128)])
def test_int4_quantize_matches_jax(shape, group_size):
    w = _rng(2).standard_normal(shape).astype(np.float32)
    want = JQ.quantize_tensor_int4(jnp.asarray(w), group_size=group_size)
    got = TQ.quantize_tensor_int4(torch.tensor(w), group_size=group_size)
    assert TQ.is_int4(got) and TQ.wshape(got) == shape
    assert got.s.dtype == torch.bfloat16 and tuple(got.s.shape) == want.s.shape
    v = TQ.qvalues(got)
    assert int(v.min()) >= -8 and int(v.max()) <= 7
    assert _rel(TQ.dequantize(got).numpy(), JQ.dequantize(want)) < INT4_REL_L2
    diff = np.asarray(want.s.astype(jnp.float32)) != got.s.float().numpy()
    assert diff.mean() <= INT4_SCALE_DIFF_FRAC, int(diff.sum())


def test_requantize_experts_int4_matches_jax():
    rng = _rng(3)
    leaves = {k: rng.standard_normal((3, 64, 96) if k != "down" else (3, 96, 64)).astype(np.float32)
              for k in ("gate", "up", "down")}
    jp = {"layers": {"moe": {g: {k: JQ.quantize_tensor(jnp.asarray(v)) for k, v in leaves.items()}
                             for g in ("dynamic", "fixed")}}}
    JQ.requantize_experts_int4_inplace(jp)
    tp = {"layers": [{"moe": {g: {k: TQ.quantize_tensor(torch.tensor(v)) for k, v in leaves.items()}
                              for g in ("dynamic", "fixed")}}]}
    TQ.requantize_experts_int4_inplace(tp)
    for g in ("dynamic", "fixed"):
        for k in ("gate", "up", "down"):
            got, want = tp["layers"][0]["moe"][g][k], jp["layers"]["moe"][g][k]
            assert TQ.is_int4(got) and TQ.is_kmajor(got.q)
            assert _rel(TQ.dequantize(got).numpy(), JQ.dequantize(want)) < INT4_REL_L2


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4", "int4_grouped"])
def test_pad_expert_ffn_matches_jax(kind):
    """F 96 pads to 128: gate/up columns (scale 1 on the new channels), down
    contraction rows (whole scale groups of 1 when group-wise)."""
    rng = _rng(4)
    leaves = {"gate": rng.standard_normal((2, 64, 96)), "up": rng.standard_normal((2, 64, 96)),
              "down": rng.standard_normal((2, 96, 64))}

    def make(q, v):
        v = np.asarray(v, np.float32)
        if kind == "bf16":
            return jnp.asarray(v) if q is JQ else torch.tensor(v)
        if kind == "int8":
            return q.quantize_tensor(jnp.asarray(v) if q is JQ else torch.tensor(v))
        gs = 32 if kind == "int4_grouped" else 0
        return q.quantize_tensor_int4(jnp.asarray(v) if q is JQ else torch.tensor(v), gs)

    jp = {"moe": {"dynamic": {k: make(JQ, v) for k, v in leaves.items()}, "fixed": {}}}
    tp = {"moe": {"dynamic": {k: make(TQ, v) for k, v in leaves.items()}, "fixed": {}}}
    JQ.pad_expert_ffn(jp)
    TQ.pad_expert_ffn(tp)
    for k in ("gate", "up", "down"):
        got, want = tp["moe"]["dynamic"][k], jp["moe"]["dynamic"][k]
        if kind == "bf16":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            continue
        assert TQ.wshape(got) == want.q.shape and TQ.is_kmajor(got.q)
        np.testing.assert_array_equal(TQ.qvalues(got).numpy(), np.asarray(want.q.astype(jnp.int8)))
        np.testing.assert_array_equal(got.s.float().numpy(), np.asarray(want.s.astype(jnp.float32)))


def test_quantize_model_params_matches_jax():
    """The tiny model's int8 pass: every quantized leaf bit-equal, expert q
    K-major, the router, norms, biases and embeddings untouched; and
    `params_to_numpy` gives the JAX package's stacked q and s back."""
    cfg = tiny_test_config()
    jp = JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu", torch.float32)
    jq = JQ.quantize_model_params(jp)
    want = params_from_jax(jax.tree.map(np.asarray, jq), cfg, "cpu")
    got = TQ.quantize_model_params(tp)
    assert not isinstance(tp["lm_head"], TQ.QTensor)         # the copy left the source alone
    for lg, lw in zip(got["layers"], want["layers"]):
        for path in (("attn", "q_proj", "w"), ("attn", "o_proj", "w"), ("moe", "dynamic", "up"),
                     ("moe", "fixed", "down")):
            g, w = lg, lw
            for k in path:
                g, w = g[k], w[k]
            assert isinstance(g, TQ.QTensor)
            np.testing.assert_array_equal(g.q.numpy(), w.q.numpy())
            np.testing.assert_array_equal(g.s.numpy(), w.s.numpy())
        assert TQ.is_kmajor(lg["moe"]["dynamic"]["gate"].q)
        assert torch.equal(lg["moe"]["gate"], lw["moe"]["gate"])
        assert torch.equal(lg["attn"]["q_proj"]["b"], lw["attn"]["q_proj"]["b"])
    for k in ("codec_head", "lm_head"):
        np.testing.assert_array_equal(got[k].q.numpy(), want[k].q.numpy())
    assert torch.equal(got["embed_tokens"], want["embed_tokens"])
    back = params_to_numpy(got)
    pairs = ((back["layers"]["moe"]["dynamic"]["down"], jq["layers"]["moe"]["dynamic"]["down"]),
             (back["layers"]["attn"]["v_proj"]["w"], jq["layers"]["attn"]["v_proj"]["w"]),
             (back["lm_head"], jq["lm_head"]))
    for leaf, jleaf in pairs:
        np.testing.assert_array_equal(leaf.q, np.asarray(jleaf.q))
        np.testing.assert_array_equal(leaf.s, np.asarray(jleaf.s))


@pytest.mark.parametrize("kind", ["int8", "int4", "int4_grouped"])
def test_qtensor_matmul_and_expert_einsum(kind):
    rng = _rng(5)
    w = rng.standard_normal((3, 64, 96)).astype(np.float32)
    x = rng.standard_normal((3, 8, 64)).astype(np.float32)
    if kind == "int8":
        tq = TQ.quantize_tensor(torch.tensor(w))
    else:
        tq = TQ.quantize_tensor_int4(torch.tensor(w), 16 if kind == "int4_grouped" else 0)
    jq = _jq(tq)
    np.testing.assert_allclose(TQ.expert_einsum("ecd,edf->ecf", torch.tensor(x), tq).numpy(),
                               np.asarray(JQ.expert_einsum("ecd,edf->ecf", jnp.asarray(x), jq)),
                               **F32_TOL)
    np.testing.assert_allclose(TQ.matmul(torch.tensor(x), tq).numpy(),
                               np.asarray(JQ.matmul(jnp.asarray(x), jq)), **F32_TOL)
    np.testing.assert_allclose(TQ.dequantize(tq).numpy(), np.asarray(JQ.dequantize(jq)), rtol=0,
                               atol=0)


def _expert_params(kind, E=4, D=64, Fd=128, seed=6):
    rng = _rng(seed)
    raw = {"gate": rng.standard_normal((E, D, Fd)) * D ** -0.5,
           "up": rng.standard_normal((E, D, Fd)) * D ** -0.5,
           "down": rng.standard_normal((E, Fd, D)) * Fd ** -0.5}
    out = {}
    for k, v in raw.items():
        v = torch.tensor(v.astype(np.float32))
        if kind in ("int8", "int4"):
            qt = TQ.quantize_tensor(v) if kind == "int8" else TQ.quantize_tensor_int4(v)
            out[k] = TQ.QTensor(TQ.kmajor(qt.q), qt.s)
        elif kind == "int4_grouped":
            out[k] = TQ.quantize_tensor_int4(v, 32)
        else:
            out[k] = v
    return out, {k: _jq(v) if isinstance(v, TQ.QTensor) else jnp.asarray(v.numpy())
                 for k, v in out.items()}


@pytest.mark.parametrize("C", [5, 16, 17, 24, 40])
def test_a8_int32_products_bit_equal(C):
    """int8 x int8 → int32 per expert, rows padded below 17 and to a
    multiple of 8: equal to the JAX einsum with preferred_element_type=int32."""
    tp, jp = _expert_params("int4")
    x = _rng(7).standard_normal((4, C, 64)).astype(np.float32)
    q, _ = TQ.act_quant_int8(torch.tensor(x))
    before = TD.int8_expert_matmul.calls
    got = TD.int8_expert_matmul(q, tp["gate"])
    assert TD.int8_expert_matmul.calls == before + 4
    want = jnp.einsum("ecd,edf->ecf", jnp.asarray(q.numpy()), jp["gate"].q,
                      preferred_element_type=jnp.int32)
    assert got.dtype == torch.int32 and got.shape == (4, C, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_a8_ffn_matches_jax(kind):
    tp, jp = _expert_params(kind)
    x = _rng(8).standard_normal((4, 24, 64)).astype(np.float32)
    x[2, 5] = 0.0
    before = TD.swiglu_expert_ffn.a8_calls
    got = TD.swiglu_expert_ffn(torch.tensor(x), tp, a8=True).numpy()
    assert TD.swiglu_expert_ffn.a8_calls == before + 1
    want = np.asarray(JD.swiglu_expert_ffn(jnp.asarray(x), jp, a8=True))
    assert _rel(got, want) < A8_REL
    # a8 moves the result: it is not the bf16 expression.
    plain = TD.swiglu_expert_ffn(torch.tensor(x), tp).numpy()
    assert _rel(plain, got) > 1e-4


def test_a8_falls_back_to_plain_expression():
    """Group-wise or raw weights are not a8-eligible: the a8 flag leaves the
    plain expression, bit for bit, and the counter untouched."""
    x = torch.tensor(_rng(9).standard_normal((4, 8, 64)).astype(np.float32))
    for kind in ("int4_grouped", "raw"):
        tp, _ = _expert_params(kind)
        before = TD.swiglu_expert_ffn.a8_calls
        assert torch.equal(TD.swiglu_expert_ffn(x, tp, a8=True), TD.swiglu_expert_ffn(x, tp))
        assert TD.swiglu_expert_ffn.a8_calls == before


def _routing(S, E, seed, k=2):
    rng = _rng(seed)
    logits = rng.standard_normal((S, E))
    mask = np.zeros((S, E), np.int32)
    top = np.argsort(-logits, axis=1)[:, :k]
    np.put_along_axis(mask, top, 1, axis=1)
    weight = np.abs(rng.standard_normal((S, E))).astype(np.float32)
    return rng.standard_normal((S, 64)).astype(np.float32), mask, weight


@pytest.mark.parametrize("path,S,cap", [("dense", 12, None), ("packed", 12, 5),
                                        ("packed", 2048, 1200)])
def test_a8_dispatch_matches_jax(path, S, cap):
    """dense_a8 and packed_a8 (one-hot matmuls at S 12, the argsort pack at
    S 2048) over int4 experts, f32."""
    tp, jp = _expert_params("int4")
    h, mask, w = _routing(S, 4, seed=10)
    if path == "dense":
        got = TD.moe_ffn_dense(torch.tensor(h), torch.tensor(mask), torch.tensor(w), tp, a8=True)
        want = JD.moe_ffn_dense(jnp.asarray(h), jnp.asarray(mask), jnp.asarray(w), jp, a8=True)
    else:
        assert (S * 4 * cap <= TD._ONEHOT_BUDGET) == (S == 12)
        got = TD.moe_ffn_packed(torch.tensor(h), torch.tensor(mask), torch.tensor(w), tp, cap,
                                a8=True)
        want = JD.moe_ffn_packed(jnp.asarray(h), jnp.asarray(mask), jnp.asarray(w), jp, cap,
                                 a8=True)
    assert _rel(got.numpy(), want) < A8_REL


@pytest.mark.parametrize("mode", ["dense_a8", "packed_a8"])
def test_dcmoe_block_a8_matches_jax(mode):
    """The whole block with int8 QTensor experts (dynamic and fixed take a8)."""
    cfg = tiny_test_config()
    tc = cfg.text_config
    jp = JM.init_model_params(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    jl = JQ.quantize_model_params(jp)["layers"]
    jmoe = jax.tree.map(lambda a: a[0], jl["moe"])
    tmoe = params_from_jax(jax.tree.map(np.asarray, JQ.quantize_model_params(jp)), cfg,
                           "cpu")["layers"][0]["moe"]
    x = _rng(11).standard_normal((2, 6, tc.hidden_size)).astype(np.float32)
    before = TD.swiglu_expert_ffn.a8_calls
    got = TB.dcmoe_block(tmoe, torch.tensor(x), tc, dispatch_mode=mode, capacity=7)
    assert TD.swiglu_expert_ffn.a8_calls == before + 2           # dynamic and fixed
    want = JB.dcmoe_block(jmoe, jnp.asarray(x), tc, dispatch_mode=mode, capacity=7)
    assert _rel(got.hidden_states.numpy(), want.hidden_states) < A8_REL
    np.testing.assert_array_equal(got.expert_mask.numpy(), np.asarray(want.expert_mask))


@pytest.mark.parametrize("kind,budget", [("int8", None), ("int8", 128), ("int4_grouped", None)])
def test_gmm_qtensor_matches_jax(kind, budget):
    """moe_ffn_gmm over QTensor experts: per-channel scales per row after the
    grouped product (through slot_expert), group-wise weights dequantized
    first; a budget of 128 rows under S x E = 160 slots drops assignments."""
    tp, jp = _expert_params(kind)
    h, mask, w = _routing(40, 4, seed=12, k=3)
    got = TD.moe_ffn_gmm(torch.tensor(h), torch.tensor(mask), torch.tensor(w), tp,
                         assignment_budget=budget)
    want = JD.moe_ffn_gmm(jnp.asarray(h), jnp.asarray(mask), jnp.asarray(w), jp,
                          assignment_budget=budget)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
