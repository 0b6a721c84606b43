"""Flash attention of the PyTorch port vs the JAX package, forward and
backward.

The port's plain versions (what a CPU tensor runs) are held against the
Pallas kernels in interpret mode and against `_reference_attention`, in f32
at the tolerances of tests/test_flash_attention.py; the gradient is held
against `jax.grad` of the Pallas flash attention and checked by
`torch.autograd.gradcheck` in f64; the plain backward in f32 is also held
against the JAX package's `_flash_backward` from the same residuals, at the
f32 kernels' tile edges.  The CUDA kernels are held against their plain
versions in bf16 and in f32 on a card; those cases skip without one.
"""

import numpy as np
import pytest
import torch

from unimoe_audio_torch.ops import flash_attention as FA
from unimoe_audio_torch.ops.flash_attention import (
    FlashAttention,
    _check,
    flash_attention,
    flash_attention_reference,
)

RTOL, ATOL = 2e-4, 2e-5
# Gradients vs jax.grad of the Pallas kernels in interpret mode (f32), as
# tests/test_flash_attention.py holds the Pallas backward to its oracle.
GRAD_RTOL, GRAD_ATOL = 2e-4, 3e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here rather than at the top so that the
    card-only cases run where JAX is not installed
    (`pytest --noconftest -m cuda tests/test_torch_flash.py`)."""
    import jax.numpy as jnp
    from unimoe_audio_tpu.ops import flash_attention as jfa

    return jnp, jfa


def _inputs(B, H, KV, T, S, Dh, pad, seed):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, T, Dh)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((B, KV, S, Dh)) * 0.5).astype(np.float32)
    v = rng.standard_normal((B, KV, S, Dh)).astype(np.float32)
    valid = np.ones((B, S), np.int32)
    if pad:
        valid[0, :pad] = 0          # left padding: sample 0's first rows are dead
        valid[-1, -3:] = 0          # and a few invalid keys at the end
    return q, k, v, valid


CASES = [
    # B, H, KV, T, S, causal, pad
    (1, 4, 2, 128, 128, True, 0),
    (2, 4, 2, 200, 200, True, 17),
    (1, 4, 2, 256, 256, False, 0),
    (2, 4, 2, 128, 128, True, 40),
    (1, 4, 2, 128, 192, True, 9),     # S > T: rectangular causal mask
    (2, 4, 4, 200, 256, False, 5),
]


# The forward kernel's tile edges (128 query rows, 128 keys per tile): one
# row and one key past a tile, one query tile against three key tiles with
# the last one ragged (S > T), and head_dim 64 with S > T.
K1_EDGES = [
    (1, 4, 2, 129, 129, True, 0),
    (1, 4, 2, 64, 300, True, 7),
    (2, 4, 2, 100, 160, True, 5),
]
K1_EDGE_DH = {K1_EDGES[2]: 64}


@pytest.mark.parametrize("B,H,KV,T,S,causal,pad", CASES + K1_EDGES)
def test_plain_matches_jax(jx, B, H, KV, T, S, causal, pad):
    jnp, jfa = jx
    Dh = K1_EDGE_DH.get((B, H, KV, T, S, causal, pad), 128)
    q, k, v, valid = _inputs(B, H, KV, T, S, Dh, pad, seed=T + S + pad)
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          torch.tensor(valid), causal=causal).numpy()
    pallas = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(valid), causal=causal, interpret=True))
    ref = np.asarray(jfa._reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(valid), causal))
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


# One head_dim per case, so both kernel widths are covered.
GRAD_DH = [128, 64, 128, 64, 128, 64]


@pytest.mark.parametrize("B,H,KV,T,S,causal,pad", CASES)
def test_backward_plain_matches_jax_grad(jx, B, H, KV, T, S, causal, pad):
    """Gradients of q, k, v through `FlashAttention` on the CPU (the plain
    backward: P from m and l, masked dS, the GQA sum) vs jax.grad of the
    Pallas flash attention; dq of dead rows exactly 0."""
    jnp, jfa = jx
    import jax

    Dh = GRAD_DH[CASES.index((B, H, KV, T, S, causal, pad))]
    q, k, v, valid = _inputs(B, H, KV, T, S, Dh, pad, seed=T + S + pad + 1)
    g = np.random.default_rng(pad).standard_normal((B, H, T, Dh)).astype(np.float32)

    def f(a, b, c):
        return jnp.sum(jfa.flash_attention(a, b, c, jnp.asarray(valid), causal=causal,
                                           interpret=True) * g)

    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    (flash_attention(tq, tk, tv, torch.tensor(valid), causal=causal)
     * torch.tensor(g)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    allowed = (valid[:, None, :] > 0) & (np.tril(np.ones((T, S), bool), S - T) if causal
                                         else np.ones((T, S), bool))
    dead = ~allowed.any(-1)                                  # [B, T]
    assert dead.any() == (pad > S - T and causal)
    assert (tq.grad.numpy().transpose(0, 2, 1, 3)[dead] == 0).all()


# bf16 cases for the per-head rounding of dk and dv: GQA groups of 2 and 4,
# both head dims, S > T, left padding.
BF16_BWD_CASES = [
    # B, H, KV, T, S, Dh, pad
    (1, 4, 2, 128, 128, 128, 0),
    (2, 4, 2, 200, 200, 64, 17),
    (1, 8, 2, 128, 192, 128, 9),
]
# Plain bf16 backward vs the JAX package's bf16 backward on the same
# residuals: both round P, dS and each head's dk, dv to bf16 at the same
# points, so they differ only where an f32 sum taken in another order lands
# on the other side of a bf16 rounding.  Summing the heads in f32 and
# rounding once (the port's rounding before the per-head kernels) does not
# meet this limit.
BF16_BWD_REL_L2 = 1e-4
BF16_BWD_RTOL, BF16_BWD_ATOL = 8e-3, 1e-3       # one bf16 step


@pytest.mark.parametrize("B,H,KV,T,S,Dh,pad", BF16_BWD_CASES)
def test_backward_plain_bf16_rounds_as_jax(jx, B, H, KV, T, S, Dh, pad):
    """The plain dq and dk/dv versions in bf16 (what the CUDA kernels are
    held to on the card) against the JAX package's `_flash_backward` in bf16
    (Pallas in interpret mode) from the JAX forward's o, m, l: each query
    head's dk and dv is rounded to bf16 before the GQA sum, as there."""
    jnp, jfa = jx
    q, k, v, valid = _inputs(B, H, KV, T, S, Dh, pad, seed=T + S + pad + 2)
    g = np.random.default_rng(pad + 1).standard_normal((B, H, T, Dh)).astype(np.float32)
    jq, jk, jv, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, g))
    jvalid = jnp.asarray(valid)
    o, m, l = jfa._flash_forward(jq, jk, jv, jvalid, True, 512, 512, True)
    want = jfa._flash_backward(jq, jk, jv, jvalid, o, m, l, jg, True, 512, 512, True)

    def bf16(a):
        return torch.tensor(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(torch.bfloat16)

    tq, tk, tv, tg, to = (bf16(a) for a in (jq, jk, jv, jg, o))
    tm = torch.tensor(np.asarray(m)[:, :T, 0])
    tl = torch.tensor(np.asarray(l)[:, :T, 0])
    vt = torch.tensor(valid)
    dvec = FA.softmax_residual_rowsum(tg, to)
    dq = FA.flash_attention_bwd_dq(tq, tk, tv, tg, tm, tl, dvec, vt, True)
    dk, dv = FA.flash_attention_bwd_dkv(tq, tk, tv, tg, tm, tl, dvec, vt, True)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == torch.bfloat16
        got, w = got.float(), torch.tensor(np.asarray(w.astype(jnp.float32)))
        assert ((got - w).norm() / w.norm()).item() <= BF16_BWD_REL_L2
        torch.testing.assert_close(got, w, rtol=BF16_BWD_RTOL, atol=BF16_BWD_ATOL)


# The f32 kernels' tile edges (K1 and K2: 128 query rows, 32-key tiles; K3:
# 64 keys, 64-row query tiles; K1's own in K1_F32_EDGES below): one row and one
# key past a tile (65, 129, S 65 over T 64), S - T = 45 and 90 so that K3's
# key tiles start their query range in mid-tile, T > S with dead rows (also
# at head_dim 64), head_dim 64, GQA 8:1 over one kv head and 1:1 (causal and
# not).
F32_EDGES = [
    # B, H, KV, T, S, Dh, pad, causal
    (1, 4, 2, 65, 65, 128, 0, True),
    (2, 4, 2, 100, 145, 64, 9, True),
    (1, 4, 4, 130, 97, 128, 3, True),
    (1, 8, 2, 96, 96, 64, 5, False),
    (1, 4, 2, 129, 129, 128, 0, True),
    (1, 8, 1, 64, 65, 64, 7, True),
    (1, 4, 2, 100, 190, 128, 3, True),
    (1, 4, 2, 160, 97, 64, 3, True),
    (1, 2, 2, 65, 130, 128, 3, False),
]


@pytest.mark.parametrize("B,H,KV,T,S,Dh,pad,causal", F32_EDGES)
def test_plain_f32_matches_jax_kernels(jx, B, H, KV, T, S, Dh, pad, causal):
    """The plain versions in f32 (what the f32 kernels are held to on the
    card) against the JAX package's Pallas kernels in f32, interpret mode:
    o, m, l of `_flash_forward`, then dq, dk, dv of `_flash_backward` from
    the JAX forward's residuals."""
    jnp, jfa = jx
    q, k, v, valid = _inputs(B, H, KV, T, S, Dh, pad, seed=T + S + Dh)
    g = np.random.default_rng(T).standard_normal((B, H, T, Dh)).astype(np.float32)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    jvalid = jnp.asarray(valid)
    o, m, l = jfa._flash_forward(jq, jk, jv, jvalid, causal, 512, 512, True)
    tq, tk, tv, tg = (torch.tensor(a) for a in (q, k, v, g))
    vt = torch.tensor(valid)
    to, tm, tl = flash_attention(tq, tk, tv, vt, causal=causal, return_stats=True)
    jm, jl = np.asarray(m)[:, :T, 0], np.asarray(l)[:, :T, 0]
    np.testing.assert_allclose(to.numpy(), np.asarray(o), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.numpy(), jm, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=RTOL, atol=ATOL)
    want = jfa._flash_backward(jq, jk, jv, jvalid, o, m, l, jg, causal, 512, 512, True)
    jo = torch.tensor(np.asarray(o))
    dvec = FA.softmax_residual_rowsum(tg, jo)
    tm, tl = torch.tensor(jm), torch.tensor(jl)
    dq = FA.flash_attention_bwd_dq(tq, tk, tv, tg, tm, tl, dvec, vt, causal)
    dk, dv = FA.flash_attention_bwd_dkv(tq, tk, tv, tg, tm, tl, dvec, vt, causal)
    for got, w in zip((dq, dk, dv), want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=GRAD_RTOL, atol=GRAD_ATOL)


# The f32 backward kernels' bar against their plain versions (chip_smoke's
# BWD_F32_RTOL, BWD_F32_ATOL, BWD_F32_REL_L2): elementwise, and the relative
# L2 error of the whole tensor.
F32_BWD_RTOL, F32_BWD_ATOL = 1e-4, 1e-4
F32_BWD_REL_L2 = 1e-5


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero,
    on the int32 view, as `cvt.rna.tf32.f32` rounds."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_rz(x):
    """x cut to TF32 toward zero (its low 13 mantissa bits dropped), as the
    tensor core reads an f32 register given as a .tf32 operand."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b, lo_round=_tf32_rz):
    """a @ b as the f32 backward kernels form it: each operand split into
    hi = tf32(x) (to nearest) and lo = x - hi read as TF32 (toward zero in
    the kernels: `lo_round`), hi_a hi_b + (hi_a lo_b + lo_a hi_b), lo_a lo_b
    dropped; the products of TF32 values are exact in f32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = lo_round(a - ah), lo_round(b - bh)
    return ah @ bh + (ah @ bl + al @ bh)


@pytest.mark.parametrize("lo_round", [_tf32_rz, _tf32], ids=["lo_toward_zero", "lo_to_nearest"])
@pytest.mark.parametrize("B,H,KV,T,S,Dh,pad,causal", [
    (1, 4, 2, 512, 512, 128, 0, True), (2, 4, 2, 100, 145, 64, 9, True),
    (1, 8, 1, 129, 129, 128, 3, True), (1, 2, 2, 65, 130, 64, 3, False)])
def test_3xtf32_split_meets_the_f32_bar(B, H, KV, T, S, Dh, pad, causal, lo_round):
    """The arithmetic of the f32 backward kernels on the CPU: dq, dk and dv
    recomputed from the plain formulas with every product in 3xTF32 (the
    split emulated on the int32 view, lo read toward zero as the kernels
    read it, or rounded to nearest) meet the card's bar against the plain
    f32 versions (rtol 1e-4, atol 1e-4, relative L2 1e-5), and TF32 alone
    (one product of the rounded operands) does not."""
    q, k, v, valid = (torch.tensor(a) for a in _inputs(B, H, KV, T, S, Dh, pad, seed=T + Dh))
    do = torch.tensor(np.random.default_rng(S).standard_normal((B, H, T, Dh)).astype(np.float32))
    o, m, l = flash_attention_reference(q, k, v, valid, causal, return_stats=True)
    dvec = FA.softmax_residual_rowsum(do, o)
    args = (q, k, v, do, m, l, dvec, valid, causal)
    want = (FA.flash_attention_bwd_dq_reference(*args), *FA.flash_attention_bwd_dkv_reference(*args))

    def grads(mm):
        kk, vv = (x.repeat_interleave(H // KV, dim=1) for x in (k, v))
        scale = Dh ** -0.5
        allowed = FA._allowed(valid, T, S, causal)
        s = mm(q, kk.transpose(-1, -2)) * scale
        linv = 1.0 / l.reshape(B, H, T, 1).clamp_min(1e-30)
        p = torch.where(allowed, torch.exp(s - m.reshape(B, H, T, 1)) * linv, 0.0)
        dp = mm(do, vv.transpose(-1, -2))
        ds = torch.where(allowed, p * (dp - dvec.reshape(B, H, T, 1)), 0.0)
        dq = mm(ds, kk) * scale
        dk = (mm(ds.transpose(-1, -2), q) * scale).reshape(B, KV, H // KV, S, Dh).sum(2)
        dv = mm(p.transpose(-1, -2), do).reshape(B, KV, H // KV, S, Dh).sum(2)
        return dq, dk, dv

    def meets(got):
        return all(bool(((g - w).abs() <= F32_BWD_ATOL + F32_BWD_RTOL * w.abs()).all())
                   and ((g - w).norm() / w.norm()).item() <= F32_BWD_REL_L2
                   for g, w in zip(got, want))

    for g, w in zip(grads(lambda a, b: _mm_3xtf32(a, b, lo_round)), want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=F32_BWD_RTOL, atol=F32_BWD_ATOL)
        assert ((g - w).norm() / w.norm()).item() <= F32_BWD_REL_L2
    assert not meets(grads(lambda a, b: _tf32(a) @ _tf32(b)))


# The f32 forward kernel's bar beyond F32_RTOL / F32_ATOL (below): the
# relative L2 error of o.
F32_FWD_REL_L2 = 1e-5


@pytest.mark.parametrize("lo_round", [_tf32_rz, _tf32], ids=["lo_toward_zero", "lo_to_nearest"])
@pytest.mark.parametrize("B,H,KV,T,S,Dh,pad,causal", [
    (1, 4, 2, 512, 512, 128, 0, True), (2, 4, 2, 100, 145, 64, 9, True),
    (1, 8, 1, 129, 129, 128, 3, True), (1, 2, 2, 65, 130, 64, 3, False)])
def test_3xtf32_forward_meets_the_f32_bar(B, H, KV, T, S, Dh, pad, causal, lo_round):
    """The arithmetic of the f32 forward kernel on the CPU: o, m and l
    recomputed with S = Q K^T and P V in 3xTF32 (the softmax taken exactly,
    in f32) meet the card's bar against the plain f32 version (rtol 1e-4,
    atol 1e-5, and o's relative L2 1e-5), and TF32 alone does not."""
    q, k, v, valid = (torch.tensor(a) for a in _inputs(B, H, KV, T, S, Dh, pad, seed=T + Dh))
    want = flash_attention_reference(q, k, v, valid, causal, return_stats=True)

    def forward(mm):
        kk, vv = (x.repeat_interleave(H // KV, dim=1) for x in (k, v))
        allowed = FA._allowed(valid, T, S, causal)
        live = allowed.any(-1, keepdim=True)
        s = torch.where(allowed, mm(q, kk.transpose(-1, -2)) * Dh ** -0.5, FA.NEG_INF)
        m = s.amax(-1, keepdim=True)
        p = torch.where(allowed, torch.exp(s - m), 0.0)
        l = p.sum(-1, keepdim=True)
        o = torch.where(live, mm(p, vv) / l.clamp_min(1e-30), 0.0)
        l = torch.where(live, l, -FA.NEG_INF)
        return o, m.reshape(B * H, T), l.reshape(B * H, T)

    def meets(got):
        return all(bool(((g - w).abs() <= F32_ATOL + F32_RTOL * w.abs()).all())
                   for g, w in zip(got, want)) \
            and ((got[0] - want[0]).norm() / want[0].norm()).item() <= F32_FWD_REL_L2

    got = forward(lambda a, b: _mm_3xtf32(a, b, lo_round))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=F32_RTOL, atol=F32_ATOL)
    assert ((got[0] - want[0]).norm() / want[0].norm()).item() <= F32_FWD_REL_L2
    assert not meets(forward(lambda a, b: _tf32(a) @ _tf32(b)))


def test_tf32_rounding_is_round_to_nearest_away():
    """`_tf32` keeps 10 mantissa bits, rounds to nearest, breaks ties away
    from zero, and leaves lo = x - hi exact below half a TF32 step; lo read
    toward zero (`_tf32_rz`) stays within 2^-22 of x."""
    one = 1.0
    step = 2.0 ** -10
    x = torch.tensor([one, one + step / 2, -(one + step / 2), one + step / 4,
                      one + 3 * step / 4, 3.0, 1e-3], dtype=torch.float32)
    got = _tf32(x)
    assert got.tolist() == [one, one + step, -(one + step), one, one + step, 3.0,
                            _tf32(torch.tensor([1e-3])).item()]
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    r = torch.tensor(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
    hi = _tf32(r)
    assert bool(((r - hi).abs() <= hi.abs() * 2.0 ** -11).all())
    lo = _tf32(r - hi)
    assert bool(((r - hi - lo).abs() <= r.abs() * 2.0 ** -21).all())
    lz = _tf32_rz(r - hi)
    assert bool(((r - hi - lz).abs() <= r.abs() * 2.0 ** -22).all())
    assert bool((lz.abs() <= (r - hi).abs()).all())


def test_gradcheck_f64():
    """FlashAttention's backward (the plain version on the CPU) against
    finite differences, f64: GQA, left padding with a dead row, S > T."""
    rng = np.random.default_rng(7)
    q = torch.tensor(rng.standard_normal((2, 4, 5, 8)), requires_grad=True)
    k = torch.tensor(rng.standard_normal((2, 2, 7, 8)), requires_grad=True)
    v = torch.tensor(rng.standard_normal((2, 2, 7, 8)), requires_grad=True)
    valid = torch.ones(2, 7, dtype=torch.int32)
    valid[0, :4] = 0                                      # query row 0 of sample 0 is dead
    for causal in (True, False):
        assert torch.autograd.gradcheck(
            lambda a, b, c: FlashAttention.apply(a, b, c, valid, causal)[0], (q, k, v))


def test_grad_path_counts_no_kernel_launch_and_stats_carry_no_grad():
    before = (flash_attention.launches, FA.flash_attention_bwd_dq.launches,
              FA.flash_attention_bwd_dkv.launches)
    q, k, v, valid = _inputs(1, 4, 2, 16, 16, 64, 0, seed=0)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o, m, l = flash_attention(tq, tk, tv, torch.tensor(valid), return_stats=True)
    assert o.requires_grad and not m.requires_grad and not l.requires_grad
    o.sum().backward()
    assert tq.grad is not None and tk.grad is not None and tv.grad is not None
    assert (flash_attention.launches, FA.flash_attention_bwd_dq.launches,
            FA.flash_attention_bwd_dkv.launches) == before


def test_dead_rows_are_zero_and_stats_match_jax(jx):
    """Left-padded query rows with no attendable key output exactly 0; the
    softmax residuals m, l equal the Pallas kernel's (dead rows: m = -1e30,
    l = 1e30)."""
    jnp, jfa = jx
    B, H, KV, T, S = 2, 4, 2, 128, 128
    q, k, v, valid = _inputs(B, H, KV, T, S, 128, pad=30, seed=3)
    o, m, l = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                  torch.tensor(valid), causal=True, return_stats=True)
    assert (o[0, :, :30] == 0).all()
    assert (o[0, :, 30:].abs().sum(-1) > 0).all()
    _, jm, jl = jfa._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(valid), True, 512, 512, True)
    jm = np.asarray(jm)[:, :T, 0]
    jl = np.asarray(jl)[:, :T, 0]
    np.testing.assert_allclose(m.numpy(), jm, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(l.numpy(), jl, rtol=RTOL, atol=ATOL)
    assert (m.reshape(B, H, T)[0, :, :30] == -1e30).all()
    assert (l.reshape(B, H, T)[0, :, :30] == 1e30).all()


def test_cpu_path_counts_no_kernel_launch():
    before = flash_attention.launches
    q, k, v, valid = _inputs(1, 4, 2, 128, 128, 64, 0, seed=0)
    flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(valid))
    assert flash_attention.launches == before


def test_kernel_input_checks_raise():
    """What the kernels do not take is refused before launch: head_dim
    outside {64, 128}, dtypes other than bf16 and f32 (and q, k, v of two
    dtypes), non-contiguous inputs, a malformed mask, H not a multiple of
    KV."""
    bf = torch.bfloat16

    def qkv(Dh=128, dtype=bf, H=4, KV=2):
        return (torch.zeros(1, H, 8, Dh, dtype=dtype), torch.zeros(1, KV, 8, Dh, dtype=dtype),
                torch.zeros(1, KV, 8, Dh, dtype=dtype))

    valid = torch.ones(1, 8, dtype=torch.int32)
    assert _check(*qkv(), valid) == (1, 4, 2, 8, 8, 128)
    assert _check(*qkv(dtype=torch.float32), valid) == (1, 4, 2, 8, 8, 128)
    bad = [
        (qkv(Dh=96), valid),
        (qkv(dtype=torch.float16), valid),
        ((qkv(dtype=torch.float32)[0],) + qkv()[1:], valid),
        ((qkv()[0].transpose(2, 3).contiguous().transpose(2, 3),) + qkv()[1:], valid),
        (qkv(), valid.long()),
        (qkv(), torch.ones(1, 9, dtype=torch.int32)),
        (qkv(H=3, KV=2), valid),
    ]
    for args, mask in bad:
        with pytest.raises(ValueError):
            _check(*args, mask)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,pad,Dh", [(128, 128, 0, 128), (192, 192, 37, 128),
                                        (128, 200, 11, 64), (70, 70, 5, 128),
                                        (129, 129, 0, 128), (64, 300, 7, 128),
                                        (100, 300, 5, 64), (2048, 2048, 0, 128)])
def test_kernel_matches_plain_bf16(cuda, T, S, pad, Dh):
    """The CUDA kernel vs its plain version in bf16 at prefill-like shapes,
    the tile edges of the kernel (129 rows and keys; one query tile over
    three key tiles; Dh 64 with S > T) and the training shape (the plain
    version rounds probabilities to bf16 too): atol 2e-2 on unit-scale
    values; dead rows exactly 0; m, l within 1e-2 relative."""
    q, k, v, valid = _inputs(4, 16, 2, T, S, Dh, pad, seed=T + pad)
    args = [torch.tensor(a, device=cuda) for a in (q, k, v)]
    args = [a.to(torch.bfloat16) for a in args]
    vt = torch.tensor(valid, device=cuda)
    before = flash_attention.launches
    o, m, l = flash_attention(*args, vt, causal=True, return_stats=True)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ro, rm, rl = flash_attention_reference(*args, vt, True, return_stats=True)
    torch.testing.assert_close(o.float(), ro.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(m, rm, rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(l, rl, rtol=1e-2, atol=1e-2)
    dead = ~((vt[:, None, None, :] > 0)
             & torch.ones(T, S, dtype=torch.bool, device=cuda).tril(S - T)).any(-1)
    assert (o.float().abs().sum(-1)[dead.expand(4, 16, T)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_cuda_prefill_takes_kernel_or_raises(cuda, dtype):
    """A causal self-attention of 128 tokens on the card takes the flash
    kernel, as the reference takes its Pallas kernel there: in bf16 the bf16
    kernel launches, in f32 the f32 kernel; f16 is refused.  It never falls
    back to the einsum path."""
    from unimoe_audio_torch.config import tiny_test_config
    from unimoe_audio_torch.models import layers as TL

    cfg = tiny_test_config(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2).text_config
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = TL.init_attention_params(gen, cfg, dtype=dtype, device=cuda)
    B, T = 2, 128
    x = torch.randn(B, T, cfg.hidden_size, generator=gen, device=cuda).to(dtype)
    pos = torch.arange(T, device=cuda)[None, None].expand(3, B, T)
    cos, sin = TL.compute_mrope(pos, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
    before = (flash_attention.launches, flash_attention.f32_launches)
    if dtype in (torch.bfloat16, torch.float32):
        out, _ = TL.attention(params, x, cos, sin, cfg)
        torch.cuda.synchronize()
        f32 = dtype == torch.float32
        assert (flash_attention.launches, flash_attention.f32_launches) == \
            (before[0] + (not f32), before[1] + f32)
        assert out.shape == (B, T, cfg.hidden_size) and bool(torch.isfinite(out).all())
    else:
        with pytest.raises(ValueError, match="bf16 or f32"):
            TL.attention(params, x, cos, sin, cfg)
        assert (flash_attention.launches, flash_attention.f32_launches) == before


def _bwd_inputs(cuda, T, S, pad, Dh, causal):
    """bf16 q, k, v, dO, the forward kernel's residuals m, l, D and kv_valid
    (B 4, H 16, KV 2) on the card."""
    q, k, v, valid = _inputs(4, 16, 2, T, S, Dh, pad, seed=T + pad)
    q, k, v = (torch.tensor(a, device=cuda).to(torch.bfloat16) for a in (q, k, v))
    vt = torch.tensor(valid, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(T + S)
    do = torch.randn(4, 16, T, Dh, generator=gen, device=cuda).to(torch.bfloat16)
    o, m, l = flash_attention(q, k, v, vt, causal=causal, return_stats=True)
    return q, k, v, do, m, l, FA.softmax_residual_rowsum(do, o), vt


# The backward kernels' tile edges (dq: 128 query rows, 64-key tiles; dk/dv:
# 128 keys, 64-row query tiles): one row and one key past a tile; one query
# tile over five key tiles; Dh 64 with S > T; S - T = 90, so dk/dv's key
# tiles 1 and 2 start their query range in mid-tile.
K23_EDGES = [(129, 129, 0, 128, True), (64, 300, 7, 128, True), (100, 300, 5, 64, True),
             (200, 290, 3, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,pad,Dh,causal", [(128, 128, 0, 128, True), (200, 200, 37, 128, True),
                                               (128, 200, 11, 64, True), (192, 192, 5, 128, False)]
                         + K23_EDGES)
def test_backward_kernels_match_plain_bf16(cuda, T, S, pad, Dh, causal):
    """The dq and dk/dv kernels vs their plain versions in bf16, from the
    forward kernel's residuals, at prefill-like shapes and the kernels' tile
    edges: atol = rtol = 2e-2 (both round P and dS to bf16); dq of dead rows
    exactly 0."""
    q, k, v, do, m, l, dvec, vt = _bwd_inputs(cuda, T, S, pad, Dh, causal)
    before = (FA.flash_attention_bwd_dq.launches, FA.flash_attention_bwd_dkv.launches,
              FA.flash_attention_bwd_dkv.reduce_launches)
    dq = FA.flash_attention_bwd_dq(q, k, v, do, m, l, dvec, vt, causal)
    dk, dv = FA.flash_attention_bwd_dkv(q, k, v, do, m, l, dvec, vt, causal)
    torch.cuda.synchronize()
    assert (FA.flash_attention_bwd_dq.launches, FA.flash_attention_bwd_dkv.launches,
            FA.flash_attention_bwd_dkv.reduce_launches) == tuple(b + 1 for b in before)
    rdq = FA.flash_attention_bwd_dq_reference(q, k, v, do, m, l, dvec, vt, causal)
    rdk, rdv = FA.flash_attention_bwd_dkv_reference(q, k, v, do, m, l, dvec, vt, causal)
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    allowed = (vt[:, None, :] > 0) & torch.ones(T, S, dtype=torch.bool, device=cuda).tril(
        S - T if causal else S)
    dead = ~allowed.any(-1)
    assert (dq.float().abs().sum(-1)[dead[:, None].expand(4, 16, T)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,pad,Dh,causal", [(2048, 2048, 0, 128, True), (200, 290, 3, 128, True),
                                               (192, 192, 5, 64, False)])
def test_backward_kernels_bit_identical(cuda, T, S, pad, Dh, causal):
    """Two launches of the dq and dk/dv kernels on the same inputs give the
    same bits: no atomics, and the GQA sum runs in head order."""
    args = _bwd_inputs(cuda, T, S, pad, Dh, causal)
    first = (FA.flash_attention_bwd_dq(*args, causal), *FA.flash_attention_bwd_dkv(*args, causal))
    again = (FA.flash_attention_bwd_dq(*args, causal), *FA.flash_attention_bwd_dkv(*args, causal))
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.cuda
def test_cuda_attention_backward_launches_both_kernels(cuda):
    """A bf16 backward through `attention` at T = 128 on the card runs the
    forward kernel once and each backward kernel once."""
    from unimoe_audio_torch.config import tiny_test_config
    from unimoe_audio_torch.models import layers as TL

    cfg = tiny_test_config(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2).text_config
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = TL.init_attention_params(gen, cfg, dtype=torch.bfloat16, device=cuda)
    B, T = 2, 128
    x = torch.randn(B, T, cfg.hidden_size, generator=gen, device=cuda).to(torch.bfloat16)
    x.requires_grad_(True)
    pos = torch.arange(T, device=cuda)[None, None].expand(3, B, T)
    cos, sin = TL.compute_mrope(pos, cfg.head_dim, cfg.rope_theta, cfg.mrope_section)
    before = (flash_attention.launches, FA.flash_attention_bwd_dq.launches,
              FA.flash_attention_bwd_dkv.launches)
    out, _ = TL.attention(params, x, cos, sin, cfg)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (flash_attention.launches, FA.flash_attention_bwd_dq.launches,
            FA.flash_attention_bwd_dkv.launches) == tuple(b + 1 for b in before)
    assert x.grad is not None and bool(torch.isfinite(x.grad).all()) and x.grad.abs().sum() > 0


# The f32 kernels vs their plain versions on the card: both the forward and
# the backward run their products in 3xTF32 (about 21 bits a product;
# F32_FWD_REL_L2 and F32_BWD_* above); they differ in the order of their
# sums and in exp's last bits.
F32_RTOL, F32_ATOL = 1e-4, 1e-5

# K1's own tile edges in f32 (128 query rows, 32-key tiles): one row and one
# key past two row tiles, one row tile over ten key tiles with the last
# ragged, a second row tile of one row at Dh 64, GQA 8:1 over one kv head
# and H = KV.
K1_F32_EDGES = [
    # B, H, KV, T, S, Dh, pad, causal
    (1, 4, 2, 257, 257, 128, 0, True),
    (1, 4, 2, 128, 300, 128, 7, True),
    (1, 4, 2, 129, 193, 64, 5, True),
    (1, 8, 1, 129, 129, 128, 3, True),
    (1, 4, 4, 200, 200, 128, 9, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,T,S,Dh,pad,causal", F32_EDGES + K1_F32_EDGES + [
    (4, 16, 2, 128, 128, 128, 0, True), (4, 16, 2, 2048, 2048, 128, 0, True)])
def test_f32_kernels_match_plain(cuda, B, H, KV, T, S, Dh, pad, causal):
    """K1 (`csrc/flash_attention_f32.cu`), K2 and K3
    (`csrc/flash_attention_bwd_f32.cu`) in f32 vs their plain versions at
    the f32 kernels' tile edges, the T2M prefill shape and the training
    shape: o, m, l (o also within the relative L2 bar), then dq, dk, dv from
    the kernel's residuals (also within the relative L2 bar); dead rows
    exactly 0; a second launch of each kernel gives the same bits; the f32
    counters count each launch, the bf16 ones none, and the f32 dk/dv
    kernel launches no separate GQA sum."""
    q, k, v, valid = _inputs(B, H, KV, T, S, Dh, pad, seed=T + S + Dh)
    q, k, v = (torch.tensor(a, device=cuda) for a in (q, k, v))
    vt = torch.tensor(valid, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(T)
    do = torch.randn(B, H, T, Dh, generator=gen, device=cuda)
    names = ("launches", "f32_launches")
    fns = (flash_attention, FA.flash_attention_bwd_dq, FA.flash_attention_bwd_dkv)
    before = [getattr(f, n) for f in fns for n in names]
    reduces = FA.flash_attention_bwd_dkv.f32_reduce_launches
    o, m, l = flash_attention(q, k, v, vt, causal=causal, return_stats=True)
    fwd_again = flash_attention(q, k, v, vt, causal=causal, return_stats=True)
    dvec = FA.softmax_residual_rowsum(do, o)
    args = (q, k, v, do, m, l, dvec, vt, causal)
    got = (FA.flash_attention_bwd_dq(*args), *FA.flash_attention_bwd_dkv(*args))
    again = (FA.flash_attention_bwd_dq(*args), *FA.flash_attention_bwd_dkv(*args))
    torch.cuda.synchronize()
    assert [getattr(f, n) for f in fns for n in names] == \
        [b + d for b, d in zip(before, (0, 2, 0, 2, 0, 2))]
    assert FA.flash_attention_bwd_dkv.f32_reduce_launches == reduces
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip((o, m, l), fwd_again))
    ro, rm, rl = flash_attention_reference(q, k, v, vt, causal, return_stats=True)
    torch.testing.assert_close(o, ro, rtol=F32_RTOL, atol=F32_ATOL)
    assert ((o - ro).norm() / ro.norm()).item() <= F32_FWD_REL_L2
    torch.testing.assert_close(m, rm, rtol=F32_RTOL, atol=F32_ATOL)
    torch.testing.assert_close(l, rl, rtol=F32_RTOL, atol=F32_ATOL)
    want = (FA.flash_attention_bwd_dq_reference(*args), *FA.flash_attention_bwd_dkv_reference(*args))
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.float32 and torch.equal(a.view(torch.int32), b.view(torch.int32))
        torch.testing.assert_close(a, w, rtol=F32_BWD_RTOL, atol=F32_BWD_ATOL)
        assert ((a - w).norm() / w.norm()).item() <= F32_BWD_REL_L2
    allowed = (vt[:, None, :] > 0) & torch.ones(T, S, dtype=torch.bool, device=cuda).tril(
        S - T if causal else S)
    dead = ~allowed.any(-1)[:, None].expand(B, H, T)
    assert (o.abs().sum(-1)[dead] == 0).all() and (got[0].abs().sum(-1)[dead] == 0).all()
