"""The packed and grouped-GEMM (gmm) dispatch of the PyTorch port vs the JAX
package, on the CPU: the plain versions of the grouped-GEMM kernels against
megablox `gmm` / `tgmm` in interpret mode (ragged groups with empty ones,
`transpose_rhs`, f32 and bf16) and `grouped_matmul`'s gradients against
`jax.vjp` of megablox `gmm`; `moe_ffn_gmm` with and without an assignment
budget (value and gradients); `moe_ffn_packed` through both of its
branches; the packing helpers; `dcmoe_block` in each dispatch mode, at
inference and in training, and `token_drop` with both policies.  The
kernels themselves are held against the plain versions on the card
(`cuda` cases).

Tolerances: f32 on both sides is the same arithmetic in another order, so
values at 1e-5; gradients, sums over hundreds of rows, at rtol 1e-4 with an
absolute floor of 1e-5 of the tensor's largest magnitude; bf16 is stated
where it is used.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from unimoe_audio_torch.config import tiny_test_config
from unimoe_audio_torch.core.bridge import to_torch
from unimoe_audio_torch.moe import block as TB
from unimoe_audio_torch.moe import dispatch as TDsp
from unimoe_audio_torch.ops import grouped_gemm as GG
from tests.torch_threads import one_torch_thread  # noqa: F401

@pytest.fixture(scope="module")
def jx():
    """The JAX reference, imported here rather than at the top so that the
    card-only cases run where JAX is not installed (`pytest --noconftest
    -m cuda tests/test_torch_dispatch.py`)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.tpu.megablox import gmm as gmm_vjp
    from jax.experimental.pallas.ops.tpu.megablox.gmm import gmm, tgmm
    from unimoe_audio_tpu.moe import block, dispatch

    return SimpleNamespace(jax=jax, jnp=jnp, gmm=gmm, tgmm=tgmm, gmm_vjp=gmm_vjp, JB=block,
                           JDsp=dispatch)


RTOL = ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
TILING = (128, 128, 128)

# Ragged groups over 256 rows: the first, a middle and the last group empty,
# a group smaller than a 128-row tile, boundaries inside tiles.
GROUPS = np.array([0, 70, 0, 3, 97, 86, 0], np.int32)


def _operands(jnp, seed, A, x_cols, w_shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((A, x_cols)).astype(np.float32)
    w = (rng.standard_normal(w_shape) * w_shape[-2] ** -0.5).astype(np.float32)
    return jnp.asarray(x, dtype), jnp.asarray(w, dtype)


def _grad_close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_REL * max(float(np.abs(want).max()), 1e-12),
                               err_msg=msg)


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a, np.float32))
    return t.to(dtype) if dtype is not None else t


@pytest.mark.parametrize("transpose_rhs", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_plain_matches_megablox(jx, dtype, transpose_rhs):
    """The plain `gmm` equals megablox `gmm` in interpret mode.  f32 at 1e-5.
    bf16: both multiply the bf16 inputs exactly and sum in f32; the
    forward's f32 output at 1e-5, the transposed form's bf16 output (the
    VJP's dx dtype) within 2 bf16 ulps (rtol 8e-3), for rounding an f32 sum
    that differs in its last bits."""
    jdt = jx.jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    E, K, N = len(GROUPS), 128, 256
    x, w = _operands(jx.jnp, 0, int(GROUPS.sum()), N if transpose_rhs else K, (E, K, N), jdt)
    out_dtype = jdt if transpose_rhs else jx.jnp.float32
    want = jx.gmm(x, w, jx.jnp.asarray(GROUPS), out_dtype, TILING,
                  transpose_rhs=transpose_rhs, interpret=True)
    got = GG.gmm(_t(x, tdt), _t(w, tdt), torch.tensor(GROUPS), transpose_rhs=transpose_rhs)
    assert got.dtype == (tdt if transpose_rhs else torch.float32)
    rtol = 8e-3 if (transpose_rhs and dtype == "bfloat16") else RTOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=rtol,
                               atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_transposed_plain_matches_megablox_at_ragged_edges(jx, dtype):
    """The transposed case of the test above where K4ᵀ's tiles are ragged:
    an output width of 300 (not a multiple of its 256 columns) and a
    contraction of 200 (not a multiple of its 64-deep stages); tolerances as
    above."""
    jdt = jx.jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    E, K, N = len(GROUPS), 300, 200
    x, w = _operands(jx.jnp, 4, int(GROUPS.sum()), N, (E, K, N), jdt)
    want = jx.gmm(x, w, jx.jnp.asarray(GROUPS), jdt, TILING, transpose_rhs=True, interpret=True)
    got = GG.gmm(_t(x, tdt), _t(w, tdt), torch.tensor(GROUPS), transpose_rhs=True)
    assert got.shape == (int(GROUPS.sum()), K) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=RTOL if dtype == "float32" else 8e-3, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tgmm_plain_matches_megablox(jx, dtype):
    """The plain `tgmm` equals megablox `tgmm` (empty groups give zeros).
    f32 at 1e-5; bf16 output within 2 bf16 ulps (rtol 8e-3), as above."""
    jdt = jx.jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    E, K, N = len(GROUPS), 128, 128
    x, dy = _operands(jx.jnp, 1, int(GROUPS.sum()), K, (int(GROUPS.sum()), N), jdt)
    want = jx.tgmm(x.T, dy, jx.jnp.asarray(GROUPS), jdt, TILING, interpret=True)
    got = GG.tgmm(_t(x, tdt), _t(dy, tdt), torch.tensor(GROUPS), E)
    assert got.shape == (E, K, N) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=RTOL if dtype == "float32" else 8e-3, atol=ATOL)
    assert not got[GROUPS == 0].any()


def test_grouped_matmul_grads_match_megablox_vjp(jx):
    """`grouped_matmul`'s forward and its gradients (K4ᵀ for dx, K5 for dW
    in the plain versions) equal `jax.vjp` of megablox `gmm`, f32."""
    E, K, N = len(GROUPS), 128, 128
    x, w = _operands(jx.jnp, 2, int(GROUPS.sum()), K, (E, K, N), jx.jnp.float32)
    c = np.random.default_rng(3).standard_normal((x.shape[0], N)).astype(np.float32)
    gs = jx.jnp.asarray(GROUPS)
    out, vjp = jx.jax.vjp(lambda a, b: jx.gmm_vjp(a, b, gs, jx.jnp.float32, TILING, None, None,
                                                  False, True), x, w)
    jdx, jdw = vjp(jx.jnp.asarray(c))
    tx = _t(x).requires_grad_(True)
    tw = _t(w).requires_grad_(True)
    got = GG.grouped_matmul(tx, tw, torch.tensor(GROUPS))
    (got * torch.tensor(c)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=RTOL, atol=ATOL)
    _grad_close(tx.grad.numpy(), jdx, "dx")
    _grad_close(tw.grad.numpy(), jdw, "dw")
    assert not tw.grad[GROUPS == 0].any()


def _expert_params(seed, E, dim, F):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
            for k, s in (("gate", (E, dim, F)), ("up", (E, dim, F)), ("down", (E, F, dim)))}


def _routing(seed, S, E, density):
    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(S, E)) < density).astype(np.int32)
    return mask, rng.uniform(size=(S, E)).astype(np.float32)


@pytest.mark.parametrize("budget", [None, 128])
def test_moe_ffn_gmm_matches_jax(jx, budget):
    """`moe_ffn_gmm` vs JAX's (megablox in interpret mode): the output and
    the gradients of Σ c · out with respect to the hidden states, the
    router weight and the three expert weights, f32.  About 180 of the 256
    slots are selected, so budget 128 drops the highest experts' last
    assignments."""
    S, E, dim, F = 64, 4, 128, 96
    params = _expert_params(4, E, dim, F)
    hidden = np.random.default_rng(5).standard_normal((S, dim)).astype(np.float32)
    mask, rw = _routing(6, S, E, 0.7)
    c = np.random.default_rng(7).standard_normal((S, dim)).astype(np.float32)
    assert mask.sum() > 128

    jnp = jx.jnp

    def jloss(h, w, p):
        return jnp.sum(jx.JDsp.moe_ffn_gmm(h, jnp.asarray(mask), w, p,
                                           assignment_budget=budget) * c)

    jv, (jgh, jgw, jgp) = jx.jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(hidden), jnp.asarray(rw), {k: jnp.asarray(v) for k, v in params.items()})
    th = torch.tensor(hidden, requires_grad=True)
    tw = torch.tensor(rw, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    out = TDsp.moe_ffn_gmm(th, torch.tensor(mask), tw, tp, assignment_budget=budget)
    loss = (out * torch.tensor(c)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=RTOL)
    _grad_close(th.grad.numpy(), jgh, "hidden")
    _grad_close(tw.grad.numpy(), jgw, "router weight")
    for k in params:
        _grad_close(tp[k].grad.numpy(), jgp[k], k)
    if budget is not None:       # the budget really dropped assignments
        full = TDsp.moe_ffn_gmm(torch.tensor(hidden), torch.tensor(mask), torch.tensor(rw),
                                {k: torch.tensor(v) for k, v in params.items()})
        assert (full - out.detach()).abs().max() > 1e-3


@pytest.mark.parametrize("onehot", [True, False])
@pytest.mark.parametrize("capacity", [48, 20])
def test_moe_ffn_packed_matches_jax(jx, monkeypatch, onehot, capacity):
    """`moe_ffn_packed` vs JAX's through the one-hot branch and through the
    argsort branch (both modules' `_ONEHOT_BUDGET` set to 0, so S·E·cap is
    above it), at full capacity and at a capacity that drops tokens; output
    and gradients, f32."""
    if not onehot:
        monkeypatch.setattr(jx.JDsp, "_ONEHOT_BUDGET", 0)
        monkeypatch.setattr(TDsp, "_ONEHOT_BUDGET", 0)
    S, E, dim, F = 48, 4, 16, 24
    params = _expert_params(8, E, dim, F)
    hidden = np.random.default_rng(9).standard_normal((S, dim)).astype(np.float32)
    mask, rw = _routing(10, S, E, 0.6)
    c = np.random.default_rng(11).standard_normal((S, dim)).astype(np.float32)

    jnp = jx.jnp

    def jloss(h, w, p):
        return jnp.sum(jx.JDsp.moe_ffn_packed(h, jnp.asarray(mask), w, p, capacity) * c)

    jv, (jgh, jgw, jgp) = jx.jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(hidden), jnp.asarray(rw), {k: jnp.asarray(v) for k, v in params.items()})
    th = torch.tensor(hidden, requires_grad=True)
    tw = torch.tensor(rw, requires_grad=True)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    loss = (TDsp.moe_ffn_packed(th, torch.tensor(mask), tw, tp, capacity) * torch.tensor(c)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jv), rtol=RTOL)
    _grad_close(th.grad.numpy(), jgh, "hidden")
    _grad_close(tw.grad.numpy(), jgw, "router weight")
    for k in params:
        _grad_close(tp[k].grad.numpy(), jgp[k], k)


def test_packing_helpers_match_jax(jx):
    """`pack_by_expert`, `combine_from_packed`, `_dispatch_onehot`,
    `compress_matrix` (capacity below and above S), `decompress_matrix` and
    `ep_capacity` equal the JAX package's (integers exactly, f32 at 1e-6)."""
    S, E, dim, cap = 20, 3, 5, 6
    mask, rw = _routing(12, S, E, 0.5)
    rng = np.random.default_rng(13)
    hidden = rng.standard_normal((S, dim)).astype(np.float32)
    jm, tm = jx.jnp.asarray(mask), torch.tensor(mask)
    for got, want in zip(TDsp.pack_by_expert(torch.tensor(hidden), tm, cap),
                         jx.JDsp.pack_by_expert(jx.jnp.asarray(hidden), jm, cap)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    y = rng.standard_normal((E, cap, dim)).astype(np.float32)
    _, _, pos = jx.JDsp.pack_by_expert(jx.jnp.asarray(hidden), jm, cap)
    np.testing.assert_allclose(
        TDsp.combine_from_packed(torch.tensor(y), torch.tensor(np.asarray(pos)), tm,
                                 torch.tensor(rw)).numpy(),
        np.asarray(jx.JDsp.combine_from_packed(jx.jnp.asarray(y), pos, jm, jx.jnp.asarray(rw))),
        rtol=1e-6, atol=1e-6)
    for got, want in zip(TDsp._dispatch_onehot(tm, cap), jx.JDsp._dispatch_onehot(jm, cap)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    A3 = rng.standard_normal((S, E, 4)).astype(np.float32)
    for arr in (A3, mask.astype(np.float32)):
        for force_dim in (int(mask.sum(0).max()), S + 7):
            want = jx.JDsp.compress_matrix(jx.jnp.asarray(arr), jm, force_dim)
            got = TDsp.compress_matrix(torch.tensor(arr), tm, force_dim)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
            np.testing.assert_allclose(TDsp.decompress_matrix(got, tm).numpy(),
                                       np.asarray(jx.JDsp.decompress_matrix(want, jm)), rtol=1e-6)
    assert int(TDsp.ep_capacity(tm)) == int(jx.JDsp.ep_capacity(jm))


def _block_case(jx, seed, training):
    cfg = dataclasses.replace(tiny_test_config().text_config, input_jitter_noise=0.0)
    jp = jx.JB.init_dcmoe_params(jx.jax.random.PRNGKey(seed), cfg, dtype=jx.jnp.float32)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 9, cfg.hidden_size)).astype(np.float32)
    c = rng.standard_normal(x.shape).astype(np.float32)
    pad = np.ones((2, 9), np.int32)
    pad[1, :2] = 0
    return cfg, jp, x, c, pad


def _block_grads_match(jx, cfg, jp, x, c, pad, training, **kw):
    """Σ c · out + 3 · aux of the JAX and the port block, with the gradients
    (hidden states and every parameter) when training."""
    def jloss(p, h):
        out = jx.JB.dcmoe_block(p, h, cfg, padding_token_mask=jx.jnp.asarray(pad),
                                training=training,
                                rng=jx.jax.random.PRNGKey(0) if training else None, **kw)
        return jx.jnp.sum(out.hidden_states * c) + 3.0 * out.aux_loss, out

    tp = to_torch(jx.jax.tree.map(np.asarray, jp), "cpu", torch.float32)
    leaves = [tp["gate"], *tp["dynamic"].values(), *tp["fixed"].values()]
    tx = torch.tensor(x, requires_grad=training)
    for t in leaves:
        t.requires_grad_(training)
    out = TB.dcmoe_block(tp, tx, cfg, padding_token_mask=torch.tensor(pad), training=training,
                         seed=0 if training else None, **kw)
    loss = (out.hidden_states * torch.tensor(c)).sum() + 3.0 * out.aux_loss
    if not training:
        jv, jout = jloss(jp, jx.jnp.asarray(x))
    else:
        (jv, jout), (jgp, jgx) = jx.jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            jp, jx.jnp.asarray(x))
        loss.backward()
        _grad_close(tx.grad.numpy(), jgx, "hidden")
        want = [jgp["gate"], *jgp["dynamic"].values(), *jgp["fixed"].values()]
        for t, w in zip(leaves, want):
            _grad_close(t.grad.numpy(), w)
    np.testing.assert_allclose(out.hidden_states.detach().numpy(),
                               np.asarray(jout.hidden_states), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(out.expert_mask.numpy(), np.asarray(jout.expert_mask))
    np.testing.assert_allclose(loss.item(), float(jv), rtol=RTOL)
    return out


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("mode,kw", [("packed", {"capacity": 5}), ("packed", {}), ("gmm", {})])
def test_dcmoe_block_modes_match_jax(jx, mode, kw, training):
    """`dcmoe_block` in the packed and gmm dispatch modes vs JAX's, f32
    (input jitter off: the two frameworks draw different noise): output,
    expert mask and the loss at 1e-5; in training also the gradients.
    Capacity 5 drops tokens from the packed path.  (tests/test_torch_moe.py
    holds the dense mode.)"""
    cfg, jp, x, c, pad = _block_case(jx, 20, training)
    _block_grads_match(jx, cfg, jp, x, c, pad, training, dispatch_mode=mode, **kw)


@pytest.mark.parametrize("policy", ["probs", "position"])
def test_token_drop_matches_jax(jx, policy):
    """`token_drop` with each drop policy (capacity factor 0.5, min
    capacity 2: every expert keeps at most 3 of the 18 tokens), in
    training, vs JAX's: output, the dropped mask and the gradients."""
    cfg, jp, x, c, pad = _block_case(jx, 21, True)
    cfg = dataclasses.replace(cfg, token_drop=True, drop_policy=policy, capacity_factor=0.5,
                              min_capacity=2)
    out = _block_grads_match(jx, cfg, jp, x, c, pad, True)
    assert int(out.expert_mask[:, :cfg.num_dynamic_experts].sum(0).max()) <= 3


def test_unported_dispatch_raises():
    """Without a mesh, ep dispatch is the packed path (its all-to-alls over
    a one-rank group are the identity; the multi-rank cases:
    tests/test_torch_parallel.py), and ep_capacity with axis_name the local
    count; gmm_a8, a8 in training and unknown modes are errors, as in the
    JAX package.  (QTensor weights through gmm: tests/test_torch_quant.py.)"""
    cfg = tiny_test_config().text_config
    x = torch.zeros(1, 2, cfg.hidden_size)
    for kw in ({"dispatch_mode": "gmm_a8"}, {"dispatch_mode": "packed_a8", "training": True},
               {"dispatch_mode": "ep_a8", "training": True}, {"dispatch_mode": "sparse"}):
        with pytest.raises(ValueError):
            TB.dcmoe_block({}, x, cfg, **kw)
    gen = torch.Generator().manual_seed(0)
    params = TB.init_dcmoe_params(gen, cfg, dtype=torch.float32, device="cpu")
    h = torch.randn(2, 5, cfg.hidden_size, generator=gen)
    want = TB.dcmoe_block(params, h, cfg, dispatch_mode="packed").hidden_states
    got = TB.dcmoe_block(params, h, cfg, dispatch_mode="ep").hidden_states
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)   # the argsort pack
    mask = (torch.rand(10, 4, generator=gen) < 0.5).to(torch.int32)
    w = torch.rand(10, 4, generator=gen)
    hid = torch.randn(10, cfg.hidden_size, generator=gen)
    cap = int(TDsp.ep_capacity(mask, axis_name="expert"))
    assert cap == int(mask.sum(0).max())
    torch.testing.assert_close(TDsp.moe_ffn_ep(hid, mask, w, params["dynamic"], cap),
                               TDsp.moe_ffn_packed(hid, mask, w, params["dynamic"], cap),
                               rtol=1e-5, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels run on the card only")
    return torch.device("cuda")


def _cuda_case(A, K, N, sizes, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    E = len(sizes)
    x = torch.randn(A, K, generator=gen, device=dev).to(torch.bfloat16)
    w = (torch.randn(E, K, N, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
    dy = torch.randn(A, N, generator=gen, device=dev)
    return x, w, dy, torch.tensor(sizes, dtype=torch.int32, device=dev)


# Kernel vs plain version, both bf16 products summed in f32 in other orders.
KERNEL_RTOL, KERNEL_ATOL = 2e-2, 2e-2


def _close(got, want, name):
    g, w = got.float(), want.float()
    assert torch.isfinite(g).all(), f"{name}: non-finite output (an unwritten row?)"
    err = (g - w).abs()
    assert bool((err <= KERNEL_ATOL + KERNEL_RTOL * w.abs()).all()), \
        f"{name}: max err {err.max().item()}"


@pytest.mark.cuda
@pytest.mark.parametrize("A,K,N,sizes", [
    (256, 128, 256, [0, 70, 0, 3, 97, 86, 0]),
    (300, 100, 100, [17, 0, 250, 33]),       # ragged widths, rows past the groups
    (128, 2048, 2752, [5, 9, 0, 2, 7, 1, 0, 104]),
])
def test_kernels_match_plain_bf16(cuda, A, K, N, sizes):
    """K4, K4ᵀ and K5 vs their plain versions, outputs filled with NaN
    before each launch so that an unwritten element fails."""
    x, w, dy, gs = _cuda_case(A, K, N, sizes, 0, cuda)
    out = torch.full((A, N), float("nan"), device=cuda)
    GG.launch_gmm(x, w, gs, out, False)
    dx = torch.full((A, K), float("nan"), device=cuda, dtype=torch.bfloat16)
    GG.launch_gmm(dy, w, gs, dx, True)
    dw = torch.full((len(sizes), K, N), float("nan"), device=cuda, dtype=torch.bfloat16)
    GG.launch_tgmm(x, dy, gs, dw)
    torch.cuda.synchronize()
    _close(out, GG.gmm_reference(x, w, gs), "gmm")
    _close(dx, GG.gmm_reference(dy, w, gs, transpose_rhs=True), "gmm transposed")
    _close(dw, GG.tgmm_reference(x, dy, gs, len(sizes)), "tgmm")


@pytest.mark.cuda
def test_cuda_grouped_matmul_launches_or_raises(cuda):
    """On the card grouped_matmul launches K4 forward and K4ᵀ, K5 backward;
    an f32 operand raises instead of falling back."""
    x, w, _, gs = _cuda_case(256, 128, 128, [100, 0, 156], 1, cuda)
    x.requires_grad_(True)
    w.requires_grad_(True)
    def counts():
        return (GG.gmm.launches, GG.gmm.launches_by_config["small"], GG.gmm.transposed_launches,
                GG.tgmm.launches, GG.tgmm.reduce_launches)

    before = counts()
    GG.grouped_matmul(x, w, gs).sum().backward()
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 1, 1, 0)
    assert x.grad.dtype == w.grad.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="gmm_reference"):
        GG.gmm(x.detach().float(), w.detach(), gs)
    with pytest.raises(ValueError, match="tgmm_reference"):
        GG.tgmm(x.detach().float(), x.detach().float(), gs, 3)


# K4 cases for both tile configurations: boundaries inside tiles with empty
# groups; all rows in one group of 8; E = 1; E = 64; empty first and last
# groups; rows past the last group (the last tile holds only such rows);
# the decode shape; widths whose row stride is not a multiple of 16 bytes
# (cp.async), one of them odd.
GMM_CASES = [
    (256, 128, 256, [0, 70, 0, 3, 97, 86, 0]),
    (300, 64, 192, [0, 0, 0, 300, 0, 0, 0, 0]),
    (384, 192, 320, [384]),
    (1024, 128, 136, [0] + [16] * 60 + [24, 0, 40]),
    (640, 128, 256, [0, 200, 150, 290, 0]),
    (300, 128, 128, [17, 0, 200, 33]),
    (128, 2048, 2752, [5, 9, 0, 2, 7, 1, 0, 104]),
    (300, 100, 100, [17, 0, 250, 33]),
    (200, 99, 37, [60, 0, 90, 20]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("config", GG.GMM_CONFIGS)
@pytest.mark.parametrize("A,K,N,sizes", GMM_CASES)
def test_gmm_kernel_configs_match_plain(cuda, config, A, K, N, sizes):
    """K4 in each tile configuration, forced through the wrapper, vs its
    plain version, into an output filled with NaN before the launch."""
    x, w, _, gs = _cuda_case(A, K, N, sizes, 2, cuda)
    before = GG.gmm.launches_by_config[config]
    got = GG.gmm(x, w, gs, config=config)
    out = torch.full((A, N), float("nan"), device=cuda)
    GG.launch_gmm(x, w, gs, out, False, config=config)
    torch.cuda.synchronize()
    assert GG.gmm.launches_by_config[config] == before + 1
    want = GG.gmm_reference(x, w, gs)
    _close(got, want, f"gmm {config}")
    _close(out, want, f"gmm {config} (NaN-filled)")


@pytest.mark.cuda
@pytest.mark.parametrize("dy_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("A,K,N,sizes", GMM_CASES)
def test_gmm_transposed_kernel_matches_plain(cuda, dy_dtype, A, K, N, sizes):
    """K4ᵀ (dx = dy · W[g]ᵀ, the contraction over N) at K4's widths with a
    bf16 and an f32 dy, through the wrapper and into an output filled with
    NaN before the launch; N of 100 and 37 take the cp.async loads."""
    _, w, dy, gs = _cuda_case(A, K, N, sizes, 4, cuda)
    dy = dy.to(dy_dtype)
    before = GG.gmm.transposed_launches
    got = GG.gmm(dy, w, gs, transpose_rhs=True)
    out = torch.full((A, K), float("nan"), device=cuda, dtype=torch.bfloat16)
    GG.launch_gmm(dy, w, gs, out, True)
    torch.cuda.synchronize()
    assert GG.gmm.transposed_launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (A, K)
    want = GG.gmm_reference(dy, w, gs, transpose_rhs=True)
    _close(got, want, f"gmm transposed {dy_dtype}")
    _close(out, want, f"gmm transposed {dy_dtype} (NaN-filled)")


@pytest.mark.cuda
@pytest.mark.parametrize("A,K,N,sizes", [GMM_CASES[0], GMM_CASES[6], GMM_CASES[7]])
def test_gmm_transposed_f32_dy_is_rounded_once(cuda, A, K, N, sizes):
    """An f32 dy gives K4ᵀ the same dx bits as the same dy rounded to bf16
    (to nearest even) by hand: the wrapper rounds once before the launch."""
    _, w, dy, gs = _cuda_case(A, K, N, sizes, 5, cuda)
    a = GG.gmm(dy, w, gs, transpose_rhs=True)
    b = GG.gmm(dy.to(torch.bfloat16), w, gs, transpose_rhs=True)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# K5 cases: a group split over several chunks beside groups that are not,
# an empty first and last group, E = 1 over several chunks, an unaligned
# width (cp.async) with a split group.
TGMM_CASES = [
    (9000, 128, 256, [0, 10, 8500, 0, 490, 0]),
    (8300, 64, 64, [8300]),
    (4500, 100, 60, [4200, 0, 300]),
    (512, 256, 384, [0, 100, 0, 3, 97, 86, 0, 226]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("A,K,N,sizes", TGMM_CASES)
def test_tgmm_kernel_chunks_match_plain_and_repeat(cuda, A, K, N, sizes):
    """K5 vs its plain version into a NaN-filled output, and a second launch
    on the same inputs equal bit for bit (no atomics: the partials are summed
    in chunk order)."""
    x, _, dy, gs = _cuda_case(A, K, N, sizes, 3, cuda)
    E = len(sizes)
    outs = []
    for _ in range(2):
        out = torch.full((E, K, N), float("nan"), device=cuda, dtype=torch.bfloat16)
        ws = GG.launch_tgmm(x, dy, gs, out)
        outs.append(out)
    torch.cuda.synchronize()
    assert (ws is not None) == (GG.tgmm_workspace_slots(A, E) > 0)
    _close(outs[0], GG.tgmm_reference(x, dy, gs, E), "tgmm")
    assert torch.equal(outs[0], outs[1]), "tgmm: two launches differ"


def test_gmm_config_from_rows():
    """K4's configuration follows the row count: decode-sized A takes the
    small tiles, prefill and training the large ones."""
    assert GG.gmm_config(1) == GG.gmm_config(128) == "small"
    assert GG.gmm_config(GG.GMM_SMALL_MAX_ROWS) == "small"
    assert GG.gmm_config(GG.GMM_SMALL_MAX_ROWS + 1) == "large"
    assert GG.gmm_config(8192) == GG.gmm_config(65536) == "large"
    x = torch.zeros(8, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="config"):
        GG.launch_gmm(x, torch.zeros(2, 16, 8, dtype=torch.bfloat16),
                      torch.tensor([4, 4], dtype=torch.int32), torch.zeros(8, 8), False,
                      config="medium")


@pytest.mark.parametrize("shapes,path", [
    (((128, 2048), (8, 2048, 2752)), "tma"),
    (((300, 100), (4, 100, 100)), "cp.async"),
    (((300, 64), (4, 64, 36)), "cp.async"),
    (((200, 99),), "cp.async"),
])
def test_load_path_from_row_strides(shapes, path):
    """TMA where every row stride is a multiple of 16 bytes, cp.async
    otherwise; a base off 16-byte alignment also takes cp.async."""
    ts = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes]
    assert GG.load_path(*ts) == path
    if path == "tma":
        assert GG.load_path(torch.zeros(2 * 2048 + 1, dtype=torch.bfloat16)[1:].view(2, 2048)) \
            == "cp.async"


def _tgmm_slots_needed(sizes, rows, chunk):
    """The chunks of the groups with more than one, as the kernel numbers
    them (sizes clamped to the rows)."""
    need, start = 0, 0
    for n in sizes:
        end = min(start + max(n, 0), rows)
        c = -(-(end - start) // chunk) if end - start > chunk else 1
        need += c if c > 1 else 0
        start = end
    return need


@pytest.mark.parametrize("chunk", [64, 4096])
def test_tgmm_workspace_covers_every_split(chunk):
    """The workspace sized from host ints holds the partials of every split
    of the rows into groups: random splits, one group holding all rows, and
    splits at chunk + 1 rows each (the most multi-chunk groups)."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        E = int(rng.integers(1, 65))
        rows = int(rng.integers(1, 20 * chunk))
        cuts = np.sort(rng.integers(0, rows + 1, size=E - 1))
        sizes = np.diff(np.concatenate([[0], cuts, [rows]])).tolist()
        assert _tgmm_slots_needed(sizes, rows, chunk) <= GG.tgmm_workspace_slots(rows, E, chunk)
    for E, rows in ((1, 10 * chunk + 3), (8, 8 * (chunk + 1)), (64, 3 * (chunk + 1) + 5)):
        sizes = [chunk + 1] * E if rows == E * (chunk + 1) else [rows] + [0] * (E - 1)
        assert _tgmm_slots_needed(sizes, rows, chunk) <= GG.tgmm_workspace_slots(rows, E, chunk)
    assert GG.tgmm_workspace_slots(chunk, 8, chunk) == 0
    assert GG.tgmm_workspace_slots(65536, 8) == 23
