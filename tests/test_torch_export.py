"""The port's HF-layout export, profiling helpers, package facade and host
helpers, held to the JAX package's `tests/test_export_profiling.py` and
`tests/test_native.py:26-60`: the state dict back through
`convert_model_state_dict` (identity at rtol 1e-6) and equal, key for key
and byte for byte, to the JAX package's `model_params_to_state_dict` on the
same weights; the export loaded by both packages' `UniMoEAudio` (codec
logits within 1e-4); load → greedy generate → export → reload with
bit-identical wavs; F32, BF16 and F16 written by the port's own
safetensors writer and read back bit for bit; `router_stats` equal to
JAX's; `WallClock`, `timeit_in_jit` and `trace` on the CPU; the facade
(`get_model_info`, `load_model`, the banner on stderr, silent under
UNIMOE_AUDIO_QUIET, no torch on import); `mixdown` and `collate_pad` equal
to JAX's."""

import json
import os
import struct
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vt2m import stable_tokenizer
from unimoe_audio_tpu.codec import native as JN
from unimoe_audio_tpu.core import export as JE
from unimoe_audio_tpu.utils import profiling as JPROF
from unimoe_audio_torch.codec import audio_io
from unimoe_audio_torch.codec import native as TN
from unimoe_audio_torch.config import tiny_test_config
from unimoe_audio_torch.core.bridge import params_to_numpy
from unimoe_audio_torch.core.convert import convert_model_state_dict, read_safetensors
from unimoe_audio_torch.core.export import export_hf_checkpoint, model_params_to_state_dict
from unimoe_audio_torch.models.model import init_model_params, model_forward
from unimoe_audio_torch.utils import profiling as TPROF
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model():
    cfg = tiny_test_config()
    return cfg, init_model_params(cfg, seed=7, dtype=torch.float32, device="cpu")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, np.asarray(tree)


def test_export_convert_round_trip(model):
    cfg, params = model
    back = convert_model_state_dict(model_params_to_state_dict(params, cfg), cfg)
    want = dict(_leaves(params_to_numpy(params)))
    got = dict(_leaves(back))
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


def test_state_dict_equals_jax_export(model):
    """Key for key and byte for byte the JAX package's state dict of the
    same weights (f32), every weight a contiguous [out, in] copy."""
    cfg, params = model
    want = JE.model_params_to_state_dict(params_to_numpy(params), cfg)
    got = model_params_to_state_dict(params, cfg)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.is_contiguous() and g.dtype == torch.float32, k
        assert g.numpy().tobytes() == w.tobytes(), k


def test_export_loads_in_both_packages(model, tmp_path):
    """The port's model.safetensors + config.json load in the port's
    UniMoEAudio and in the JAX package's (which reads the file with the
    safetensors package): codec logits within 1e-4 of the source's."""
    from unimoe_audio_tpu.api import UniMoEAudio as JaxAudio
    from unimoe_audio_tpu.models import model as JM
    from unimoe_audio_torch.api import UniMoEAudio

    cfg, params = model
    n = export_hf_checkpoint(params, cfg, str(tmp_path))
    assert os.path.getsize(tmp_path / "model.safetensors") == n
    ids = torch.tensor([[3, 9, 27, 81, 5, 1]])
    want = model_forward(params, cfg, ids).codec_logits.numpy()
    port = UniMoEAudio(str(tmp_path), device="cpu", dtype=torch.float32)
    assert port.config.to_dict() == cfg.to_dict()
    np.testing.assert_allclose(model_forward(port.params, port.config, ids).codec_logits.numpy(),
                               want, rtol=1e-4, atol=1e-4)
    jm = JaxAudio(str(tmp_path), dtype=jnp.float32)
    got = JM.model_forward(jm.params, jm.config, jnp.asarray(ids.numpy())).codec_logits
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


def test_load_generate_export_reload_bit_identical(model, tmp_path):
    """An HF checkpoint on disk → UniMoEAudio → greedy text_to_music →
    export of the loaded params → reload → the same wavs, bit for bit."""
    from unimoe_audio_torch.api import UniMoEAudio

    cfg, params = model
    src, dst = tmp_path / "src", tmp_path / "dst"
    export_hf_checkpoint(params, cfg, str(src))

    def run(path, out):
        m = UniMoEAudio(str(path), device="cpu", dtype=torch.float32, allow_random=True,
                        tokenizer=stable_tokenizer(cfg), max_tokens=12, min_tokens=4)
        return m, m.text_to_music("round trip", output_dir=str(out), seed=0, do_sample=False)

    m1, p1 = run(src, tmp_path / "a")
    export_hf_checkpoint(m1.params, m1.config, str(dst))
    _, p2 = run(dst, tmp_path / "b")
    a1, sr1 = audio_io.read_wav(p1[0])
    a2, sr2 = audio_io.read_wav(p2[0])
    assert sr1 == sr2 and a1.size > 0
    np.testing.assert_array_equal(a1, a2)
    with open(p1[0], "rb") as f1, open(p2[0], "rb") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_safetensors_written_and_read_back_bit_exactly(model, tmp_path, dtype):
    """The writer's header is 8-byte aligned JSON with contiguous offsets;
    every tensor reads back with its dtype and bits."""
    cfg, params = model
    export_hf_checkpoint(params, cfg, str(tmp_path), dtype=dtype)
    path = tmp_path / "model.safetensors"
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    assert n % 8 == 0
    want = model_params_to_state_dict(params, cfg, getattr(torch, dtype))
    name = {"bfloat16": "BF16", "float16": "F16", "float32": "F32"}[dtype]
    end = 0
    for k, t in want.items():
        assert header[k]["dtype"] == name and header[k]["shape"] == list(t.shape)
        assert header[k]["data_offsets"][0] == end
        end = header[k]["data_offsets"][1]
    assert os.path.getsize(path) == 8 + n + end
    got = read_safetensors(str(path))
    assert list(got) == list(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype
        assert torch.equal(got[k].view(torch.uint8), t.view(torch.uint8)), k


def test_router_stats_equal_jax():
    rng = np.random.default_rng(0)
    mask = (rng.random((2, 12, 5)) < 0.4).astype(np.int32)
    topk = rng.integers(1, 4, size=(2, 12)).astype(np.int32)
    want = JPROF.router_stats(jnp.asarray(mask), jnp.asarray(topk), 4)
    got = TPROF.router_stats(torch.tensor(mask), torch.tensor(topk), 4)
    assert got == want
    assert 1 <= got["mean_top_k"] <= 4 and len(got["expert_load"]) == 4


def test_wallclock_and_timeit_on_the_cpu(tmp_path):
    clock = TPROF.WallClock()
    with clock("phase"):
        time.sleep(0.01)
    assert clock("phase").elapsed() >= 0.01
    assert clock("phase").elapsed() == 0.0              # reset by the read
    x = torch.ones(64, 64)
    clock("sync").start()
    assert clock("sync").stop(sync=x @ x) >= 0
    assert TPROF.timeit_in_jit(lambda a: a @ a, x, iters=2) > 0
    with pytest.raises(ValueError, match="device"):
        TPROF.timeit_in_jit(lambda: None)
    with TPROF.trace(str(tmp_path / "tr")):
        (x @ x).sum()
    with open(tmp_path / "tr" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_facade():
    import unimoe_audio_torch as pkg

    info = pkg.get_model_info()
    assert info["backend"] == "torch/cuda" and info["version"] == pkg.__version__
    assert set(info["tasks"]) == {"text_to_speech", "text_to_music", "video_text_to_music"}
    assert pkg.tiny_test_config().text_config.hidden_size == 64
    assert {"UniMoEAudioConfig", "TextMoEConfig", "VisionConfig", "load_model"} <= set(
        pkg.__all__)
    with pytest.raises(FileNotFoundError):
        pkg.load_model("/nonexistent", device="cpu")


def test_banner_on_stderr_and_quiet():
    """Importing the package prints one line on stderr, nothing on stdout,
    loads neither torch nor JAX, and is silent under UNIMOE_AUDIO_QUIET."""
    code = ("import sys, unimoe_audio_torch\n"
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "UNIMOE_AUDIO_QUIET")}
    env["PYTHONPATH"] = REPO
    loud = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert loud.returncode == 0 and loud.stdout.strip() == "[]"
    assert len(loud.stderr.strip().splitlines()) == 1 and "UNIMOE_AUDIO_QUIET" in loud.stderr
    quiet = subprocess.run([sys.executable, "-c", code], env=dict(env, UNIMOE_AUDIO_QUIET="1"),
                           cwd=REPO, capture_output=True, text=True, timeout=60)
    assert quiet.returncode == 0 and quiet.stderr == ""


def test_mixdown_and_collate_pad_equal_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1000, 2)).astype(np.float32)
    np.testing.assert_array_equal(TN.mixdown(x), JN.mixdown(x))
    np.testing.assert_allclose(TN.mixdown(x), x.mean(-1), rtol=1e-6)
    np.testing.assert_array_equal(TN.mixdown(x[:, 0]), JN.mixdown(x[:, 0]))
    seqs = [np.array([1, 2, 3]), np.array([4]), np.array([5, 6])]
    for kw in ({"pad_value": -1}, {"pad_value": 0, "max_len": 2}):
        np.testing.assert_array_equal(TN.collate_pad(seqs, **kw), JN.collate_pad(seqs, **kw))
    np.testing.assert_array_equal(TN.collate_pad(seqs, pad_value=-1),
                                  [[1, 2, 3], [4, -1, -1], [5, 6, -1]])
