"""The port's user-facing API on the CPU: tiny text-to-music end to end,
the CUDA default (raises without a GPU unless device='cpu'), and that the
port imports neither JAX nor the JAX package (nor ml_dtypes).

Quantized serving (the JAX package's `tests/test_api.py:116-160`): every
serving_mode x kv_cache_dtype x a8_compute constructs and generates; the
serving dispatch choice; f32 greedy generation over the JAX package's
quantized params (int8 and int4 weights, a8, the int8 cache, packed
dispatch in the prefill and the decode) gives JAX's codes, and the packed_a8
prefill's logits agree to 1e-5; a snapshot written by the JAX package loads
and gives the same greedy codes; the port's own snapshot loads where
ml_dtypes (and JAX) cannot be imported and gives the same codes as the
model that wrote it."""

import os
import subprocess
import sys
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimoe_audio_tpu.codec import delay as JDL
from unimoe_audio_tpu.generate.loop import generate_jit, pad_buffer as j_pad_buffer
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.ops import quant as JQ
from unimoe_audio_torch.api import UniMoEAudio, _bucket, t2m_prompt
from unimoe_audio_torch.codec.dac_wrapper import Dac
from unimoe_audio_torch.config import tiny_test_config
from unimoe_audio_torch.core.bridge import params_from_jax
from unimoe_audio_torch.generate.loop import generate, pad_buffer
from unimoe_audio_torch.models import model as TM
from unimoe_audio_torch.moe import dispatch as TD
from unimoe_audio_torch.ops.quant import QTensor, is_int4, is_kmajor, qvalues

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_text_to_music_tiny_end_to_end(tmp_path):
    # The default tiny codec vocab (39, EOS 36) can sample codes 32-35
    # past the tiny DAC's 32-entry codebooks; the DAC clamps them.
    cfg = tiny_test_config()
    model = UniMoEAudio(allow_random=True, config=cfg, device="cpu", dtype=torch.float32)
    captions = ["calm piano", "fast drums with a long and winding bass line"]
    paths = model.text_to_music(captions, output_dir=str(tmp_path), seed=0,
                                max_audio_seconds=0.6, min_audio_seconds=0.2)
    assert len(paths) == 2
    lengths = model.last_timings["lengths"]
    hop = model.dac.config.hop_length
    sr = model.dac.config.sample_rate
    for p, n in zip(paths, lengths):
        assert 0 < n <= 30
        with wave.open(p) as f:
            # frames × hop samples, padded to the API's 1 s minimum.
            assert f.getnframes() == max(n * hop, sr)
            pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
        assert np.abs(pcm[: n * hop]).max() > 0
    assert model.last_timings["steps"] > 0


def test_prompt_bucketing_pads_left():
    model = UniMoEAudio(allow_random=True, device="cpu", dtype=torch.float32)
    ids, mask = model._tokenize([t2m_prompt("a"), t2m_prompt(" ".join(["w"] * 60))])
    assert ids.shape[1] == _bucket(ids.shape[1]) == 128
    assert mask[0, 0] == 0 and mask[0, -1] == 1 and mask[1, -1] == 1


def test_default_device_is_cuda(tmp_path, capsys):
    """UniMoEAudio, Dac and the CLI default to CUDA (`cuda:{device_id}`)
    and raise without a GPU; text_to_speech and text_to_music_stream run on
    the instance's device."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UniMoEAudio(allow_random=True)
    with pytest.raises(RuntimeError):
        UniMoEAudio(allow_random=True, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UniMoEAudio(allow_random=True, device_id=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Dac(allow_random=True)
    from unimoe_audio_torch.apps import inference as app

    app.clear_model()
    argv = ["--task", "text_to_music", "--input", "calm piano", "--allow-random",
            "--output", str(tmp_path)]
    assert app.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().out


def test_unported_options_raise():
    """A directory without weights raises FileNotFoundError, as in the JAX
    package; without a model_path random weights must be asked for;
    unknown serving modes and cache types are errors; PEFT params load
    (tests/test_torch_peft.py generates with them)."""
    with pytest.raises(FileNotFoundError):
        UniMoEAudio("/nonexistent", allow_random=True, device="cpu")
    with pytest.raises(ValueError):
        UniMoEAudio(device="cpu")
    with pytest.raises(ValueError):
        UniMoEAudio(allow_random=True, device="cpu", serving_mode="int3")
    with pytest.raises(ValueError):
        UniMoEAudio(allow_random=True, device="cpu", kv_cache_dtype="fp8")
    cfg = tiny_test_config(num_hidden_layers=1)
    tree = {"peft": {"prompt": {"embed": np.ones((2, 3), np.float32)}},
            "layers": {"input_layernorm": np.ones((1, 4), np.float32)}}
    got = params_from_jax(tree, cfg, "cpu")
    assert torch.equal(got["peft"]["prompt"]["embed"], torch.ones(2, 3))


def test_port_imports_no_jax():
    """In a fresh interpreter (this test process has JAX loaded by
    conftest.py), importing the port loads no jax* or unimoe_audio_tpu*
    module."""
    code = (
        "import sys\n"
        "import unimoe_audio_torch, unimoe_audio_torch.api\n"
        "import unimoe_audio_torch.core.bridge, unimoe_audio_torch.ops.flash_attention\n"
        "import unimoe_audio_torch.core.export, unimoe_audio_torch.ops.gptq\n"
        "import unimoe_audio_torch.codec.native, unimoe_audio_torch.core.convert\n"
        "import unimoe_audio_torch.generate.streaming, unimoe_audio_torch.apps.inference\n"
        "import unimoe_audio_torch.models.vision, unimoe_audio_torch.apps.video\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'unimoe_audio_tpu', 'ml_dtypes'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("a8", [True, False])
@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("mode", [True, "int8", "int4", "int4-gptq"])
def test_serving_modes_generate(tmp_path, mode, kv, a8):
    """Every serving mode constructs and generates through the public entry
    point; 32 captions (64 CFG rows) take packed dispatch in the prefill and
    the decode, a8 in every DCMoE block when a8_compute is on."""
    cfg = tiny_test_config()
    m = UniMoEAudio(allow_random=True, config=cfg, device="cpu", dtype=torch.float32,
                    serving_mode=mode, kv_cache_dtype=kv, a8_compute=a8, max_tokens=10,
                    min_tokens=4, gptq_calibration={"frames": 8})
    lp = m.params["layers"][0]
    assert isinstance(lp["attn"]["q_proj"]["w"], QTensor) and isinstance(m.params["lm_head"],
                                                                         QTensor)
    up = lp["moe"]["dynamic"]["up"]
    assert is_int4(up) == (mode in ("int4", "int4-gptq"))
    assert is_kmajor(up.q) and qvalues(up).shape[-2:] == (64, 128)     # F 96 padded to 128
    before = TD.swiglu_expert_ffn.a8_calls
    paths = m.text_to_music(["tune"] * 32, output_dir=str(tmp_path), seed=0)
    L, steps = cfg.text_config.num_hidden_layers, m.last_timings["steps"]
    assert TD.swiglu_expert_ffn.a8_calls - before == (2 * L * (1 + steps) if a8 else 0)
    assert len(paths) == 32
    with wave.open(paths[0]) as f:
        assert f.getnframes() > 0


def test_serving_dispatch_choice():
    m = UniMoEAudio(allow_random=True, device="cpu", serving_mode="int4")
    assert m.serving_dispatch(64, 128) == dict(
        decode_dispatch_mode="packed_a8", decode_capacity=48, dispatch_mode="packed_a8",
        prefill_capacity=4736)
    assert m.serving_dispatch(8, 128) == dict(dispatch_mode="packed_a8", prefill_capacity=640)
    assert m.serving_dispatch(8, 64) == {}
    m.a8_compute = False
    assert m.serving_dispatch(100, 64)["decode_dispatch_mode"] == "packed"
    m.serving_mode = False
    assert m.serving_dispatch(64, 128) == {}


def _jax_serving_params(mode, seed=0):
    cfg = tiny_test_config()
    jp = JM.init_model_params(jax.random.PRNGKey(seed), cfg, dtype=jnp.float32)
    jp = JQ.pad_expert_ffn(JQ.quantize_model_params_inplace(jp))
    if mode == "int4":
        jp = JQ.requantize_experts_int4_inplace(jp)
    return cfg, jp


def _gen_inputs(cfg, B, T, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.text_config.vocab_size - 8, size=(2 * B, T)).astype(np.int32)
    mask = np.ones((2 * B, T), np.int32)
    mask[0, :3] = 0
    prefill, steps = JDL.prepare_audio_prompt(
        [None] * B, num_channels=cfg.codec_channels, bos_value=cfg.codec_bos_value,
        delay_pattern=cfg.codec_delay_pattern)
    return ids, mask, np.asarray(prefill), steps


A8_LOGITS_REL_L2 = 1e-3
GREEDY = dict(min_tokens=4, cfg_scale=3.0, temperature=1.0, top_p=1.0, cfg_filter_top_k=16,
              eos_prob_mul_factor=1.0)


def _jax_greedy(jp, cfg, ids, mask, prefill, steps, max_tokens, kw):
    return generate_jit(
        jp, cfg, jnp.asarray(ids), jnp.asarray(mask), None, j_pad_buffer(prefill, max_tokens),
        jnp.asarray(steps, jnp.int32), jax.random.PRNGKey(0), max_tokens=max_tokens,
        min_tokens=jnp.int32(GREEDY["min_tokens"]), cfg_scale=jnp.float32(GREEDY["cfg_scale"]),
        temperature=jnp.float32(1.0), top_p=jnp.float32(1.0),
        cfg_filter_top_k=GREEDY["cfg_filter_top_k"], eos_prob_mul_factor=jnp.float32(1.0),
        do_sample=False, **kw)


def _port_greedy(tp, cfg, ids, mask, prefill, steps, max_tokens, kw):
    return generate(tp, cfg, torch.tensor(ids), torch.tensor(mask), None,
                    pad_buffer(torch.tensor(prefill), max_tokens), steps, torch.Generator(),
                    max_tokens=max_tokens, do_sample=False, **GREEDY, **kw)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_serving_greedy_codes_equal_jax(mode):
    """f32, the JAX package's serving params (int8 or int4 experts, padded),
    64 CFG rows of 16 tokens: packed_a8 prefill at capacity 640 and decode
    at 48, the int8 cache; equal codes.  The prefill's codec logits agree
    to 1e-5 through packed dispatch over the quantized weights, and to
    A8_LOGITS_REL_L2 relative L2 through packed_a8: there an activation
    within an ulp of a half step of its int8 grid can round either way in
    the two frameworks, and each such flip moves a row's product by a whole
    step."""
    cfg, jp = _jax_serving_params(mode)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    ids, mask, prefill, steps = _gen_inputs(cfg, 32, 16)
    m = UniMoEAudio(allow_random=True, config=cfg, device="cpu", serving_mode=mode)
    kw = {**m.serving_dispatch(*ids.shape), "kv_dtype": "int8"}
    assert kw["dispatch_mode"] == kw["decode_dispatch_mode"] == "packed_a8"
    assert (kw["prefill_capacity"], kw["decode_capacity"]) == (640, 48)
    want = _jax_greedy(jp, cfg, ids, mask, prefill, steps, 10, kw)
    before = TD.swiglu_expert_ffn.a8_calls
    got = _port_greedy(tp, cfg, ids, mask, prefill, steps, 10, kw)
    assert TD.swiglu_expert_ffn.a8_calls > before
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))

    for dm in ("packed", "packed_a8"):
        jl = np.asarray(JM.model_forward(jp, cfg, jnp.asarray(ids),
                                         attention_mask=jnp.asarray(mask), dispatch_mode=dm,
                                         capacity=640).codec_logits)
        tl = TM.model_forward(tp, cfg, torch.tensor(ids), attention_mask=torch.tensor(mask),
                              dispatch_mode=dm, capacity=640).codec_logits.numpy()
        if dm == "packed":
            np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
        else:
            assert np.linalg.norm(tl - jl) / np.linalg.norm(jl) < A8_LOGITS_REL_L2


def test_jax_snapshot_loads_in_port(tmp_path):
    """A serving snapshot written by the JAX package (`serving.jax.pkl`:
    int4 experts widened to int8, bf16 scales) loads into the port with its
    modes and gives the same f32 greedy codes as the JAX params."""
    from unimoe_audio_tpu.core.export import save_serving_snapshot as j_save

    cfg, jp = _jax_serving_params("int4", seed=1)
    j_save(jp, cfg, str(tmp_path), serving_mode="int4", kv_cache_dtype="int8")
    m = UniMoEAudio(str(tmp_path), allow_random=True, device="cpu")
    assert (m.serving_mode, m.kv_cache_dtype) == ("int4", "int8")
    assert m.config.to_dict() == cfg.to_dict()
    up = m.params["layers"][1]["moe"]["dynamic"]["up"]
    assert is_int4(up) and is_kmajor(up.q) and up.s.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        qvalues(up).numpy(), np.asarray(jp["layers"]["moe"]["dynamic"]["up"].q[1], np.int8))
    with pytest.raises(ValueError):
        UniMoEAudio(str(tmp_path), allow_random=True, device="cpu", serving_mode="int8")
    ids, mask, prefill, steps = _gen_inputs(cfg, 2, 12, seed=1)
    kw = {"kv_dtype": "int8", "dispatch_mode": "packed_a8", "prefill_capacity": 24}
    want = _jax_greedy(jp, cfg, ids, mask, prefill, steps, 12, kw)
    got = _port_greedy(m.params, m.config, ids, mask, prefill, steps, 12, kw)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))


def test_port_snapshot_loads_without_ml_dtypes(tmp_path):
    """The port's snapshot of a bf16 int4 model (bf16 leaves as tagged
    uint16) unpickles with numpy alone: in a subprocess where importing
    ml_dtypes or jax fails, it loads, keeps the modes and dtypes, and the
    same token ids give the same greedy codes as the model that wrote it."""
    cfg = tiny_test_config()
    m = UniMoEAudio(allow_random=True, config=cfg, device="cpu", serving_mode="int4",
                    kv_cache_dtype="int8", max_tokens=12, min_tokens=4)
    snap = tmp_path / "snap"
    m.save_serving_snapshot(str(snap))
    ids, mask = m._tokenize([t2m_prompt("a"), t2m_prompt("b c d")])
    np.save(tmp_path / "ids.npy", ids)
    np.save(tmp_path / "mask.npy", mask)
    m._generate_core(ids, mask, None, "orig", output_dir=str(tmp_path), cfg_scale=3.0,
                     do_sample=False, seed=0)
    want = m.last_codes
    code = (
        "import sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        "sys.modules['jax'] = None\n"
        "import numpy as np, torch\n"
        "from unimoe_audio_torch.api import UniMoEAudio\n"
        f"d = {str(tmp_path)!r}\n"
        "m = UniMoEAudio(d + '/snap', allow_random=True, device='cpu')\n"
        "assert (m.serving_mode, m.kv_cache_dtype) == ('int4', 'int8')\n"
        "assert m.params['embed_tokens'].dtype == torch.bfloat16\n"
        "m._generate_core(np.load(d + '/ids.npy'), np.load(d + '/mask.npy'), None, 'snap',\n"
        "                 output_dir=d,\n"
        "                 cfg_scale=3.0, do_sample=False, seed=0, max_tokens=12, min_tokens=4)\n"
        "np.savez(d + '/codes.npz', *m.last_codes)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    got = np.load(tmp_path / "codes.npz")
    assert len(got.files) == len(want)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got[f"arr_{i}"], w)
