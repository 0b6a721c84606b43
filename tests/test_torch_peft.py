"""PEFT of the PyTorch port vs the JAX package, f32 on the CPU: LoRA
(`train/lora.py`: the layout of `add_lora`, `proj_matmul` with the delta over
raw and int8 bases, `merge_lora`) and prompt, P- and prefix tuning
(`train/peft.py`: `virtual_embeds`, `prefix_kv`, `prepend_virtual_tokens`),
the bridge carrying both trees, `loss_fn` values and gradients for each mode
(prefix tuning also at T = 128 through the flash route, whose plain versions
run with S = n + T here), and greedy generation through `UniMoEAudio` with the
prefix in the cache (f32 and int8), with soft prompts and with LoRA merged
and not.  Input jitter is off where losses are compared (the two frameworks
draw different noise)."""

import re
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimoe_audio_tpu import api as JAPI
from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.ops import quant as JQ
from unimoe_audio_tpu.train import lora as JL
from unimoe_audio_tpu.train import peft as JP
from unimoe_audio_tpu.train import step as JS
from unimoe_audio_torch.api import SPECIAL_TOKENS, UniMoEAudio
from unimoe_audio_torch.core.bridge import params_from_jax, params_to_numpy, to_torch
from unimoe_audio_torch.ops import quant as TQ
from unimoe_audio_torch.tokenizer import SimpleTokenizer
from unimoe_audio_torch.train import lora as TL
from unimoe_audio_torch.train import peft as TP
from unimoe_audio_torch.train import step as TS

# tests/test_torch_train.py's tolerances.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-4
INITS = {"prompt": JP.init_prompt_tuning, "ptuning": JP.init_p_tuning,
         "prefix": JP.init_prefix_tuning}


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_test_config(input_jitter_noise=0.0)
    jp = JM.init_model_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    return cfg, jp


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _with_lora(jp, seed=1):
    """JAX params with LoRA factors, lora_b made random so that it acts."""
    lp = JL.add_lora(jp, jax.random.PRNGKey(seed), rank=4, alpha=8.0)
    for k, name in enumerate(JL.DEFAULT_TARGETS):
        proj = lp["layers"]["attn"][name]
        proj["lora_b"] = 0.1 * jax.random.normal(jax.random.PRNGKey(50 + k),
                                                 proj["lora_b"].shape)
    return lp


def _with_peft(jp, cfg, mode, seed=2, n_virtual=JP.N_VIRTUAL_TOKENS):
    """JAX params with the adapters of `mode` planted at params["peft"]."""
    if mode == "lora":
        return _with_lora(jp)
    out = dict(jp)
    out["peft"] = INITS[mode](jax.random.PRNGKey(seed), cfg, n_virtual=n_virtual)
    if mode != "prompt":                           # the b's init at 0: make them act
        mlp = out["peft"][mode]["mlp"]
        mlp["b2"] = 0.05 * jax.random.normal(jax.random.PRNGKey(seed + 9), mlp["b2"].shape)
    return out


def _assert_tree_equal(got, want):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        np.testing.assert_array_equal(g, np.asarray(flat_w[path]),
                                      err_msg=jax.tree_util.keystr(path))


def _assert_tree_close(got, want, rtol, atol_rel):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_g) == len(flat_w)
    for path, g in flat_g:
        w = np.asarray(flat_w[path])
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol_rel * max(float(np.abs(w).max()), 1e-12),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("mode", ["lora", "prefix"])
def test_bridge_carries_lora_and_peft(setup, mode):
    """params_from_jax then params_to_numpy gives the JAX tree back bit for
    bit, LoRA's layer-stacked factors ([L, din, r], [L, r, dout], [L]) and
    params["peft"] included; each layer's dict holds its slice."""
    cfg, jp = setup
    tree = _np(_with_peft(jp, cfg, mode))
    tp = params_from_jax(tree, cfg, "cpu")
    _assert_tree_equal(params_to_numpy(tp), tree)
    if mode == "lora":
        q = tp["layers"][1]["attn"]["q_proj"]
        assert q["lora_a"].shape == tree["layers"]["attn"]["q_proj"]["lora_a"].shape[1:]
        assert q["lora_scale"].shape == ()
    else:
        assert set(tp["peft"]) == {mode}


@pytest.mark.parametrize("base", ["raw", "int8"])
def test_proj_matmul_lora_matches_jax(setup, base):
    """y = x·W + (x·a)·b·scale over a raw and an int8 (QTensor) base."""
    cfg, jp = setup
    proj = dict(_with_lora(jp)["layers"]["attn"]["v_proj"])
    proj = {k: v[1] for k, v in proj.items()}                   # layer 1
    if base == "int8":
        proj["w"] = JQ.quantize_tensor(proj["w"])
    x = np.random.default_rng(0).normal(size=(2, 5, cfg.text_config.hidden_size)).astype(
        np.float32)
    want = np.asarray(JQ.proj_matmul(jnp.asarray(x), proj))
    tproj = to_torch(_np(proj), "cpu", None)
    assert isinstance(tproj["w"], TQ.QTensor) == (base == "int8")
    got = TQ.proj_matmul(torch.tensor(x), tproj).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    no_lora = TQ.matmul(torch.tensor(x), tproj["w"]).numpy()
    assert np.abs(got - no_lora).max() > 1e-3                   # the delta acts


def test_merge_lora_matches_jax(setup):
    """merge_lora folds the adapters into w exactly as JAX does, drops the
    factors, and refuses a quantized base."""
    cfg, jp = setup
    lp = _with_lora(jp)
    want = _np(JL.merge_lora(lp))
    got = TL.merge_lora(params_from_jax(_np(lp), cfg, "cpu"))
    assert "lora_a" not in got["layers"][0]["attn"]["q_proj"]
    got_np = params_to_numpy(got)
    for name in JL.DEFAULT_TARGETS:
        np.testing.assert_allclose(got_np["layers"]["attn"][name]["w"],
                                   want["layers"]["attn"][name]["w"], rtol=1e-6, atol=1e-7)
    _assert_tree_equal({k: v for k, v in got_np.items() if k != "layers"},
                       {k: v for k, v in want.items() if k != "layers"})
    q = params_from_jax(_np(lp), cfg, "cpu")
    q["layers"][0]["attn"]["q_proj"]["w"] = TQ.quantize_tensor(q["layers"][0]["attn"]["q_proj"]["w"])
    with pytest.raises(AssertionError, match="quantiz"):
        TL.merge_lora(q)


def test_add_lora_layout(setup):
    """add_lora plants a [din, r], b [r, dout] zeros and scale α/r in the
    four attention projections of every layer, leaves the base untouched
    and shared, draws a with std din^-½, from a seed and the projection's
    path (crc32), the same in every process."""
    cfg, jp = setup
    tp = params_from_jax(_np(jp), cfg, "cpu")
    out = TL.add_lora(tp, 3, rank=4, alpha=8.0)
    again = TL.add_lora(tp, 3, rank=4, alpha=8.0)
    other = TL.add_lora(tp, 4, rank=4, alpha=8.0)
    D = cfg.text_config.hidden_size
    for i, lp in enumerate(out["layers"]):
        assert "lora_a" not in tp["layers"][i]["attn"]["q_proj"]
        for name in TL.DEFAULT_TARGETS:
            p = lp["attn"][name]
            din, dout = p["w"].shape
            assert p["w"] is tp["layers"][i]["attn"][name]["w"]
            assert p["lora_a"].shape == (din, 4) and p["lora_a"].dtype == torch.float32
            assert torch.equal(p["lora_b"], torch.zeros(4, dout))
            assert float(p["lora_scale"]) == 2.0
            assert torch.equal(p["lora_a"], again["layers"][i]["attn"][name]["lora_a"])
            assert not torch.equal(p["lora_a"], other["layers"][i]["attn"][name]["lora_a"])
        assert not torch.equal(lp["attn"]["q_proj"]["lora_a"][:D], lp["attn"]["k_proj"]["lora_a"])
    a = torch.stack([lp["attn"]["o_proj"]["lora_a"] for lp in out["layers"]])
    din = a.shape[1]
    assert abs(float(a.std()) * din ** 0.5 - 1.0) < 0.1
    assert not torch.equal(a[0], a[1])
    gen = torch.Generator().manual_seed(
        TS.fold_seed(3, zlib.crc32(b"layers/attn/o_proj") % 2 ** 31))
    torch.testing.assert_close(a, torch.randn(a.shape, generator=gen) * din ** -0.5)
    assert TL.merge_lora(out)["layers"][0]["attn"]["q_proj"].keys() == {"w", "b"}


@pytest.mark.parametrize("mode", ["prompt", "ptuning", "prefix"])
def test_peft_functions_match_jax(setup, mode):
    """virtual_embeds, prefix_kv ([L, n, KV, Dh]) and prepend_virtual_tokens
    (with explicit mRoPE positions) on the JAX package's adapters; the port's
    own init gives the JAX shapes and dtypes."""
    cfg, jp = setup
    peft = _with_peft(jp, cfg, mode)["peft"]
    tpeft = to_torch(_np(peft), "cpu", None)
    jv, tv = JP.virtual_embeds(peft), TP.virtual_embeds(tpeft)
    jk, tk = JP.prefix_kv(peft, cfg), TP.prefix_kv(tpeft, cfg)
    mine = {"prompt": TP.init_prompt_tuning, "ptuning": TP.init_p_tuning,
            "prefix": TP.init_prefix_tuning}[mode](torch.Generator().manual_seed(0), cfg,
                                                   device="cpu")
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), _np(peft)) == \
        jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
                     mine, is_leaf=lambda x: isinstance(x, torch.Tensor))
    if mode == "prefix":
        assert jv is None and tv is None
        tc = cfg.text_config
        for j, t in zip(jk, tk):
            assert t.shape == (tc.num_hidden_layers, JP.N_VIRTUAL_TOKENS,
                               tc.num_key_value_heads, tc.head_dim)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)
        return
    assert jk is None and tk is None
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    B, T, C, D = 2, 6, cfg.codec_channels, cfg.text_config.hidden_size
    rng = np.random.default_rng(0)
    batch = {"input_ids": rng.integers(1, 50, (B, T)), "attention_mask": np.ones((B, T), np.int32),
             "labels": rng.integers(0, 50, (B, T)),
             "codec_labels": rng.integers(0, 9, (B, T, C)),
             "codec_input_ids": rng.integers(0, 9, (B, T, C)),
             "aux_balance_weight": rng.uniform(1, 10, (B, T)).astype(np.float32),
             "position_ids": rng.integers(0, 9, (3, B, T))}
    emb = rng.normal(size=(B, T, D)).astype(np.float32)
    jb, je = JP.prepend_virtual_tokens({k: jnp.asarray(v) for k, v in batch.items()},
                                       jnp.asarray(emb), jv)
    tb, te = TP.prepend_virtual_tokens({k: torch.as_tensor(v) for k, v in batch.items()},
                                       torch.tensor(emb), tv)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-6)
    assert set(tb) == set(jb)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)


def _batch(cfg, seed, B=2, T=24):
    """Codec-placeholder rows after a text prefix, one left-padded row,
    codec labels with holes and an aux_balance_weight."""
    rng = np.random.default_rng(seed)
    C = cfg.codec_channels
    ids = rng.integers(0, cfg.text_config.vocab_size - 8, size=(B, T)).astype(np.int32)
    ids[:, 5:] = cfg.codec_placeholder_value
    mask = np.ones((B, T), np.int32)
    mask[1, :3] = 0
    codec = rng.integers(0, cfg.codec_eos_value, size=(B, T, C)).astype(np.int32)
    lab = codec.copy()
    lab[:, :6] = -100
    lab[0, 10:12, 1] = -100
    return {"input_ids": ids, "codec_input_ids": codec, "attention_mask": mask,
            "codec_labels": lab,
            "aux_balance_weight": np.where(lab[..., 0] != -100, 10.0, 1.0).astype(np.float32)}


def _grads(params, loss):
    leaves = [t for _, t in TS.named_leaves(params)]
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def rebuild(tree):
        if isinstance(tree, dict):
            return {k: rebuild(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [rebuild(v) for v in tree]
        g = next(grads)
        return torch.zeros_like(tree) if g is None else g
    return params_to_numpy(rebuild(params))


@pytest.mark.parametrize("mode,T,flash", [("lora", 24, None), ("prompt", 24, None),
                                          ("ptuning", 24, None), ("prefix", 128, True)])
def test_loss_fn_peft_matches_jax(setup, mode, T, flash):
    """loss_fn's loss and every gradient (the adapters' included) against
    JAX's (jitted: all f32), remat on.  Prefix at T 128 through the flash
    route: the plain versions of K1, K2 and K3 with S = n + T = 138 keys."""
    from unimoe_audio_torch.ops import flash_attention as FA

    cfg, jp = setup
    jpp = _with_peft(jp, cfg, mode)
    batch = _batch(cfg, seed=3, T=T)
    (jloss, _), jgrads = jax.jit(lambda p, b: jax.value_and_grad(JS.loss_fn, has_aux=True)(
        p, cfg, b, jax.random.PRNGKey(0), jnp.float32(0.025), remat=False))(
        jpp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_jax(_np(jpp), cfg, "cpu")
    TS.init_train_state(params, TS.make_optimizer())
    calls = []
    orig = FA._cpu_only
    FA._cpu_only = lambda q: calls.append(q.shape) or orig(q)
    try:
        loss, _ = TS.loss_fn(params, cfg, {k: torch.as_tensor(v) for k, v in batch.items()}, 0,
                             0.025, remat=True, use_flash=flash)
        grads = _grads(params, loss)
    finally:
        FA._cpu_only = orig
    if flash:
        L = cfg.text_config.num_hidden_layers
        assert len(calls) >= 2 * L                # forward and its remat recompute, backward
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    _assert_tree_close(grads, _np(jgrads), GRAD_RTOL, GRAD_ATOL_REL)
    if mode != "lora":
        assert np.abs(grads["peft"][mode]["embed"]).max() > 0


class StableTokenizer(SimpleTokenizer):
    """The development tokenizer with crc32 word ids in place of Python's
    salted hash(), so that prompts are the same in both packages' models."""

    def _encode(self, text):
        ids = []
        for part in re.split("(" + "|".join(map(re.escape, self.special)) + ")", text):
            if part in self.special:
                ids.append(self.special[part])
            elif part:
                ids += [10 + zlib.crc32(w.encode()) % (self.vocab_size - 20) for w in part.split()]
        return ids


@pytest.fixture(scope="module")
def models(setup, tmp_path_factory):
    """The JAX package's tiny f32 API model with the stable tokenizer and
    no DAC (the codes go to .npy files), and the port's on the same
    weights, and the JAX model's codes without adapters."""
    cfg, jp = setup
    tmp_path = tmp_path_factory.mktemp("plain")
    special = {t: 100 + i for i, t in enumerate(SPECIAL_TOKENS)}
    special["<|AUDIO_PLACEHOLDER|>"] = cfg.codec_placeholder_value
    tok = StableTokenizer(vocab_size=min(cfg.text_config.vocab_size, 10000), special=special)
    jm = JAPI.UniMoEAudio(allow_random=True, config=cfg, dtype=jnp.float32, max_tokens=16,
                          min_tokens=4, tokenizer=tok)
    jm.dac = None
    tm = UniMoEAudio(allow_random=True, config=cfg, device="cpu", dtype=torch.float32,
                     max_tokens=16, min_tokens=4, tokenizer=tok)
    tm.dac = None
    plain = [np.load(p) for p in jm.text_to_music(CAPTIONS, output_dir=str(tmp_path / "b"),
                                                  **GEN_KW)]
    return jm, tm, jax.tree.map(lambda x: x, jm.params), plain


CAPTIONS = ["calm piano", "fast drums with a walking bass line"]
GEN_KW = dict(cfg_scale=3.0, do_sample=False, seed=0, max_audio_seconds=0.32)


@pytest.mark.parametrize("mode,kv", [("prefix", None), ("prefix", "int8"), ("prompt", None),
                                     ("ptuning", None), ("lora", None), ("lora-merged", None)])
def test_greedy_codes_with_adapters_equal_jax(tmp_path, models, mode, kv):
    """f32 greedy text_to_music codes of the port equal the JAX package's
    with each adapter active: prefix tuning (4 virtual tokens) in the cache
    and in the int8 cache, prompt and P-tuning soft tokens through the
    visual_embeds scatter, LoRA (random b) unmerged and merged; the adapter
    changes the codes."""
    jm, tm, base, plain = models
    cfg = jm.config
    jp = _with_peft(base, cfg, mode.split("-")[0], seed=11, n_virtual=4)
    if mode == "lora-merged":
        jp = JL.merge_lora(jp)
    jm.params, jm.kv_cache_dtype = jp, kv
    tm.params = params_from_jax(_np(jp), cfg, "cpu")
    tm.kv_cache_dtype = kv
    want = [np.load(p) for p in jm.text_to_music(CAPTIONS, output_dir=str(tmp_path / "j"),
                                                 **GEN_KW)]
    got = [np.load(p) for p in tm.text_to_music(CAPTIONS, output_dir=str(tmp_path / "t"),
                                                **GEN_KW)]
    jm.params, jm.kv_cache_dtype = base, None
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape[0] > 0
        np.testing.assert_array_equal(g, w)
    assert any(g.shape != p.shape or not np.array_equal(g, p) for g, p in zip(got, plain))


def test_prefix_generate_chunked_equals_generate(setup):
    """generate_chunked with the prefix in the cache (its chunk buckets
    count the n prefix slots) gives generate's greedy codes across chunk
    boundaries, in the f32 and the int8 cache."""
    from unimoe_audio_torch.codec import delay as TDL
    from unimoe_audio_torch.generate.loop import generate, generate_chunked, pad_buffer

    cfg, jp = setup
    peft = _with_peft(jp, cfg, "prefix", n_virtual=4)
    tp = params_from_jax(_np(peft), cfg, "cpu")
    pkv = TP.prefix_kv(tp["peft"], cfg)
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.text_config.vocab_size - 8, size=(4, 10)))
    mask = torch.ones(4, 10, dtype=torch.int32)
    mask[1, :3] = 0
    prefill, steps = TDL.prepare_audio_prompt(
        [None] * 2, num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    kw = dict(max_tokens=24, min_tokens=4, cfg_scale=3.0, temperature=1.0, top_p=1.0,
              cfg_filter_top_k=16, eos_prob_mul_factor=1.0, do_sample=False, prefix_kv=pkv)
    for kv in (None, "int8"):
        args = (tp, cfg, ids, mask, None, pad_buffer(torch.as_tensor(prefill), 24), steps,
                torch.Generator())
        one = generate(*args, kv_dtype=kv, **kw)
        got, state = generate_chunked(*args, chunk_frames=8, return_state=True, kv_dtype=kv,
                                      **kw)
        assert got.steps > 8 and state.cache.k.shape[1] % 8 == 0
        assert torch.equal(got.codes, one.codes) and torch.equal(got.lengths, one.lengths)
