"""Weight converters and checkpoint loading of the PyTorch port vs the JAX
package on the CPU: a weight-normed torch DAC tree in descript-audio-codec
naming (both weight-norm spellings) and a synthetic HF-named UniMoE-Audio
state dict convert to the JAX package's trees exactly; the port's own
safetensors reader gives F32, BF16 and I64 back bit for bit; a model
directory of config.json + safetensors, and a `model.jax.pkl` (the JAX
package's, and the port's numpy-only one), load into `UniMoEAudio` and give
the JAX conversion's greedy codes; converted DAC weights load from a path
or DAC_WEIGHTS, and a missing explicit path raises."""

import dataclasses
import json
import math
import os
import pickle
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from unimoe_audio_tpu.codec import dac as JDAC
from unimoe_audio_tpu.codec.dac_wrapper import Dac as JDac
from unimoe_audio_tpu.config import tiny_test_config as j_tiny_test_config
from unimoe_audio_tpu.core import convert as JCV
from unimoe_audio_tpu.generate.loop import generate_jit, pad_buffer as j_pad_buffer
from unimoe_audio_torch.api import UniMoEAudio
from unimoe_audio_torch.codec import delay as TD
from unimoe_audio_torch.codec.dac import DACConfig
from unimoe_audio_torch.codec.dac_wrapper import Dac
from unimoe_audio_torch.config import UniMoEAudioConfig, tiny_test_config
from unimoe_audio_torch.core import convert as TCV
from unimoe_audio_torch.core.bridge import dac_params_from_jax, params_from_jax, to_numpy
from unimoe_audio_torch.generate.loop import generate, pad_buffer
from tests.torch_threads import one_torch_thread  # noqa: F401


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


# ---------------------------------------------------------------------------
# DAC
# ---------------------------------------------------------------------------

class _Snake(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.alpha = nn.Parameter(torch.rand(1, dim, 1) + 0.5)


class _Wrap(nn.Module):
    pass


def build_torch_dac(cfg: DACConfig, wn) -> nn.Module:
    """A torch module tree with descript-audio-codec's module paths, its
    convs weight-normed by `wn`."""

    def res_unit(dim, dil):
        ru = _Wrap()
        ru.block = nn.Sequential(
            _Snake(dim), wn(nn.Conv1d(dim, dim, 7, dilation=dil, padding=3 * dil)),
            _Snake(dim), wn(nn.Conv1d(dim, dim, 1)))
        return ru

    model = _Wrap()
    d = cfg.encoder_dim
    enc = [wn(nn.Conv1d(1, d, 7, padding=3))]
    for stride in cfg.encoder_rates:
        blk = _Wrap()
        blk.block = nn.Sequential(
            res_unit(d, 1), res_unit(d, 3), res_unit(d, 9), _Snake(d),
            wn(nn.Conv1d(d, 2 * d, 2 * stride, stride=stride, padding=math.ceil(stride / 2))))
        enc.append(blk)
        d *= 2
    enc += [_Snake(d), wn(nn.Conv1d(d, cfg.latent_dim, 3, padding=1))]
    model.encoder = _Wrap()
    model.encoder.block = nn.Sequential(*enc)

    model.quantizer = _Wrap()
    qs = []
    for _ in range(cfg.n_codebooks):
        q = _Wrap()
        q.in_proj = wn(nn.Conv1d(cfg.latent_dim, cfg.codebook_dim, 1))
        q.out_proj = wn(nn.Conv1d(cfg.codebook_dim, cfg.latent_dim, 1))
        q.codebook = nn.Embedding(cfg.codebook_size, cfg.codebook_dim)
        qs.append(q)
    model.quantizer.quantizers = nn.ModuleList(qs)

    d = cfg.decoder_dim
    dec = [wn(nn.Conv1d(cfg.latent_dim, d, 7, padding=3))]
    for stride in cfg.decoder_rates:
        blk = _Wrap()
        blk.block = nn.Sequential(
            _Snake(d),
            wn(nn.ConvTranspose1d(d, d // 2, 2 * stride, stride=stride,
                                  padding=math.ceil(stride / 2), output_padding=stride % 2)),
            res_unit(d // 2, 1), res_unit(d // 2, 3), res_unit(d // 2, 9))
        dec.append(blk)
        d //= 2
    dec += [_Snake(d), wn(nn.Conv1d(d, 1, 7, padding=3)), nn.Tanh()]
    model.decoder = _Wrap()
    model.decoder.model = nn.Sequential(*dec)
    return model


WEIGHT_NORMS = {
    "weight_g": nn.utils.weight_norm,
    "parametrizations": nn.utils.parametrizations.weight_norm,
}


def _dac_state_dict(wn_name):
    cfg = DACConfig(**dataclasses.asdict(JDAC.tiny_dac_config()))
    torch.manual_seed(0)
    return cfg, build_torch_dac(cfg, WEIGHT_NORMS[wn_name]).state_dict()


@pytest.mark.parametrize("wn_name", sorted(WEIGHT_NORMS))
def test_dac_state_dict_converts_equal_to_jax(wn_name):
    cfg, sd = _dac_state_dict(wn_name)
    assert any(k.endswith(("weight_g", "original0")) for k in sd)
    kw = dict(n_enc_blocks=len(cfg.encoder_rates), n_dec_blocks=len(cfg.decoder_rates),
              n_codebooks=cfg.n_codebooks)
    got = TCV.convert_dac_state_dict(sd, **kw)
    _assert_trees_equal(got, JCV.convert_dac_state_dict(sd, **kw))
    np.testing.assert_allclose(got["encoder"]["conv_in_w"],
                               TCV.fold_weight_norm(*(sd[k].numpy() for k in sorted(
                                   k for k in sd if k.startswith("encoder.block.0.")
                                   and "bias" not in k))), rtol=0, atol=0)


def test_dac_weights_file_loads_in_both_packages(tmp_path, monkeypatch):
    """`convert_dac_weights` of a .pth (state dict + metadata) writes the
    file the JAX package's converter writes; each package's Dac loads the
    other's, found by path or through DAC_WEIGHTS, and encodes alike."""
    cfg, sd = _dac_state_dict("weight_g")
    pth = tmp_path / "weights_16khz.pth"
    torch.save({"state_dict": sd, "metadata": {"kwargs": {
        **dataclasses.asdict(cfg), "codebook_dim": [cfg.codebook_dim]}}}, pth)
    TCV.convert_dac_weights(str(pth), str(tmp_path / "port" / "dac.pkl"))
    JCV.convert_dac_weights(str(pth), str(tmp_path / "jax.pkl"))
    with open(tmp_path / "port" / "dac.pkl", "rb") as f:
        port_blob = pickle.load(f)
    with open(tmp_path / "jax.pkl", "rb") as f:
        jax_blob = pickle.load(f)
    assert port_blob["config"] == {**jax_blob["config"]}
    _assert_trees_equal(port_blob["params"], jax_blob["params"])

    td = Dac(str(tmp_path / "jax.pkl"), device="cpu")
    assert td.config == cfg
    jd = JDac(str(tmp_path / "port" / "dac.pkl"))
    audio = np.sin(np.arange(700) / 7.0).astype(np.float32) * 0.3
    np.testing.assert_array_equal(td.encode_array(audio, 16000), jd.encode_array(audio, 16000))
    monkeypatch.setenv("DAC_WEIGHTS", str(tmp_path / "port" / "dac.pkl"))
    _assert_trees_equal(to_numpy(Dac(device="cpu").params), to_numpy(td.params))
    with pytest.raises(FileNotFoundError, match="DAC weights not found"):
        Dac(str(tmp_path / "missing.pkl"), device="cpu")
    monkeypatch.delenv("DAC_WEIGHTS")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        Dac(device="cpu")


# ---------------------------------------------------------------------------
# Safetensors
# ---------------------------------------------------------------------------

_ST_NAMES = {torch.float32: "F32", torch.bfloat16: "BF16", torch.int64: "I64"}


def write_safetensors(path, tensors: dict) -> None:
    """The format by hand: header length (u64 LE), JSON header, raw bytes."""
    header, blobs, off = {"__metadata__": {"format": "pt"}}, [], 0
    for name, t in tensors.items():
        t = t.contiguous()
        raw = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h + b"".join(blobs))


def test_safetensors_reader_bit_exact(tmp_path):
    g = torch.Generator().manual_seed(0)
    tensors = {
        "a.f32": torch.randn(3, 5, generator=g) * 1e3,
        "b.bf16": (torch.randn(4, 2, 3, generator=g) * 7).to(torch.bfloat16),
        "c.i64": torch.randint(-2 ** 62, 2 ** 62, (6,), generator=g),
        "d.scalar": torch.tensor(1.5),
    }
    tensors["b.bf16"][0, 0, :2] = torch.tensor([float("inf"), float("nan")])
    write_safetensors(tmp_path / "one.safetensors", tensors)
    write_safetensors(tmp_path / "two.safetensors", {"e.more": torch.arange(4.0)})
    got = TCV.load_hf_safetensors(str(tmp_path))
    assert set(got) == set(tensors) | {"e.more"}
    for name, t in tensors.items():
        assert got[name].dtype == t.dtype and got[name].shape == t.shape
        bits = torch.int16 if t.dtype == torch.bfloat16 else t.dtype
        assert torch.equal(got[name].view(bits), t.view(bits)), name


# ---------------------------------------------------------------------------
# The main model
# ---------------------------------------------------------------------------

def _hf_state_dict(cfg, seed=0):
    """HF-named weights of the tiny config (torch tensors), biases on q/k/v,
    the norms in bf16 as a checkpoint may store them."""
    tc = cfg.text_config
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def add(name, shape, scale=0.1, dtype=torch.float32):
        sd[name] = (torch.randn(*shape, generator=g) * scale).to(dtype)

    D, V = tc.hidden_size, tc.vocab_size
    H, KV, Dh = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    add("language_model.embed_tokens.weight", (V, D))
    add("language_model.norm.weight", (D,), 1.0, torch.bfloat16)
    add("lm_head.weight", (V, D))
    for c in range(cfg.codec_channels):
        add(f"codec_embed_tokens.{c}.weight", (cfg.codec_embed_size, D), 0.5)
    add("codec_head.weight", (cfg.codec_channels * cfg.codec_embed_size, D), 0.5)
    for l in range(tc.num_hidden_layers):
        p = f"language_model.layers.{l}"
        add(f"{p}.input_layernorm.weight", (D,), 1.0, torch.bfloat16)
        add(f"{p}.post_attention_layernorm.weight", (D,), 1.0, torch.bfloat16)
        for proj, n in (("q", H), ("k", KV), ("v", KV)):
            add(f"{p}.self_attn.{proj}_proj.weight", (n * Dh, D))
            add(f"{p}.self_attn.{proj}_proj.bias", (n * Dh,))
        add(f"{p}.self_attn.o_proj.weight", (D, H * Dh))
        add(f"{p}.mlp.gate.weight", (tc.num_experts, D), 0.5)
        for fmt, n, F in (
                (f"{p}.mlp.dynamic_real_moe.deepspeed_moe.experts.deepspeed_experts.{{}}",
                 tc.mlp_dynamic_expert_num, tc.dynamic_intermediate_size),
                (f"{p}.mlp.fixed_real_moe.{{}}", tc.mlp_fixed_expert_num,
                 tc.shared_intermediate_size)):
            for e in range(n):
                add(f"{fmt.format(e)}.gate_proj.weight", (F, D))
                add(f"{fmt.format(e)}.up_proj.weight", (F, D))
                add(f"{fmt.format(e)}.down_proj.weight", (D, F))
    return sd


def test_model_state_dict_converts_equal_to_jax():
    cfg = tiny_test_config()
    sd = _hf_state_dict(cfg)
    _assert_trees_equal(TCV.convert_model_state_dict(sd, cfg),
                        JCV.convert_model_state_dict(sd, j_tiny_test_config()))
    tied = {k: v for k, v in sd.items() if k != "lm_head.weight"}
    _assert_trees_equal(TCV.convert_model_state_dict(tied, cfg),
                        JCV.convert_model_state_dict(tied, j_tiny_test_config()))


def _greedy_inputs(cfg):
    rng = np.random.default_rng(5)
    ids = rng.integers(0, cfg.text_config.vocab_size - 8, size=(4, 10)).astype(np.int32)
    mask = np.ones((4, 10), np.int32)
    mask[0, :4] = 0
    prefill, steps = TD.prepare_audio_prompt([None] * 2, num_channels=cfg.codec_channels,
                                             bos_value=cfg.codec_bos_value,
                                             delay_pattern=cfg.codec_delay_pattern)
    return ids, mask, prefill, steps


GREEDY = dict(min_tokens=4, cfg_scale=3.0, temperature=1.0, top_p=1.0, cfg_filter_top_k=16,
              eos_prob_mul_factor=1.0, do_sample=False)


def _port_codes(params, cfg, max_tokens=16):
    ids, mask, prefill, steps = _greedy_inputs(cfg)
    res = generate(params, cfg, torch.tensor(ids), torch.tensor(mask), None,
                   pad_buffer(torch.tensor(prefill), max_tokens), steps, torch.Generator(),
                   max_tokens=max_tokens, **GREEDY)
    return res.codes.numpy()


def _jax_codes(jp, cfg, max_tokens=16):
    ids, mask, prefill, steps = _greedy_inputs(cfg)
    kw = {k: v for k, v in GREEDY.items() if k not in ("do_sample", "cfg_filter_top_k")}
    res = generate_jit(jp, cfg, jnp.asarray(ids), jnp.asarray(mask), None,
                       j_pad_buffer(prefill, max_tokens), jnp.asarray(steps, jnp.int32),
                       jax.random.PRNGKey(0), max_tokens=max_tokens,
                       cfg_filter_top_k=GREEDY["cfg_filter_top_k"], do_sample=False,
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    return np.asarray(res.codes)


def test_model_dir_with_safetensors_loads(tmp_path):
    """config.json + two safetensors shards (F32 and BF16 leaves): the
    loaded f32 params equal the bridged JAX conversion of the same state
    dict, and greedy generation gives JAX's codes over it; without a DAC
    file generation writes codes files."""
    cfg = tiny_test_config()
    sd = _hf_state_dict(cfg, seed=1)
    names = sorted(sd)
    write_safetensors(tmp_path / "model-00001-of-00002.safetensors",
                      {k: sd[k] for k in names[: len(names) // 2]})
    write_safetensors(tmp_path / "model-00002-of-00002.safetensors",
                      {k: sd[k] for k in names[len(names) // 2:]})
    cfg.save_json(str(tmp_path / "config.json"))
    m = UniMoEAudio(str(tmp_path), device="cpu", dtype=torch.float32,
                    tokenizer=lambda *a, **k: None)
    assert m.dac is None and m.config.to_dict() == cfg.to_dict()
    jcfg = j_tiny_test_config()
    jtree = JCV.convert_model_state_dict(sd, jcfg)
    want_params = params_from_jax(jtree, cfg, "cpu", torch.float32)
    _assert_trees_equal(to_numpy(m.params), to_numpy(want_params))
    want = _jax_codes(jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jtree), jcfg)
    np.testing.assert_array_equal(_port_codes(m.params, cfg), want)

    ids, mask, _, _ = _greedy_inputs(cfg)
    paths = m._generate_core(ids, mask, None, "ck", output_dir=str(tmp_path / "out"),
                             cfg_scale=3.0, do_sample=False, seed=0, max_tokens=12, min_tokens=4)
    assert all(p.endswith(".wav.codes.npy") and os.path.isfile(p) for p in paths)
    np.testing.assert_array_equal(np.load(paths[0]), m.last_codes[0])


def test_model_jax_pkl_loads(tmp_path):
    """A `model.jax.pkl` as the JAX package writes it (bf16 leaves as
    ml_dtypes arrays, the gate f32) and the port's `convert_model_weights`
    file (numpy-only) load with the JAX package's params and codes."""
    cfg = tiny_test_config()
    jcfg = j_tiny_test_config()
    sd = _hf_state_dict(cfg, seed=2)
    jtree = jax.tree.map(lambda a: np.asarray(a, dtype=jnp.bfloat16),
                         JCV.convert_model_state_dict(sd, jcfg))
    jtree["layers"]["moe"]["gate"] = np.asarray(jtree["layers"]["moe"]["gate"], np.float32)
    (tmp_path / "jax").mkdir()
    with open(tmp_path / "jax" / "model.jax.pkl", "wb") as f:
        pickle.dump({"params": jtree, "config": jcfg.to_dict()}, f)
    want = _jax_codes(jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jtree), jcfg)
    m = UniMoEAudio(str(tmp_path / "jax"), device="cpu", dtype=torch.float32,
                    allow_random=True)
    np.testing.assert_array_equal(_port_codes(m.params, cfg), want)

    (tmp_path / "hf").mkdir()
    write_safetensors(tmp_path / "hf" / "model.safetensors", sd)
    cfg.save_json(str(tmp_path / "hf" / "config.json"))
    (tmp_path / "port").mkdir()
    TCV.convert_model_weights(str(tmp_path / "hf"), str(tmp_path / "port" / "model.jax.pkl"))
    with open(tmp_path / "port" / "model.jax.pkl", "rb") as f:
        blob = pickle.load(f)
    assert blob["params"]["layers"]["moe"]["gate"].dtype == np.float32
    assert set(blob["params"]["embed_tokens"]) == {"__bf16__"}
    m = UniMoEAudio(str(tmp_path / "port"), device="cpu", dtype=torch.float32,
                    allow_random=True)
    assert UniMoEAudioConfig.from_dict(blob["config"]).to_dict() == cfg.to_dict()
    np.testing.assert_array_equal(_port_codes(m.params, cfg), want)
    gate = m.params["layers"][0]["moe"]["gate"]
    np.testing.assert_array_equal(gate.numpy(), np.asarray(jtree["layers"]["moe"]["gate"][0]))
