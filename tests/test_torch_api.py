"""The port's user-facing API on the CPU: tiny text-to-music end to end,
the CUDA default (raises without a GPU unless device='cpu'), and that the
port imports neither JAX nor the JAX package."""

import os
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from unimoe_audio_torch.api import UniMoEAudio, _bucket, t2m_prompt
from unimoe_audio_torch.config import tiny_test_config

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


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        UniMoEAudio(allow_random=True)
    with pytest.raises(RuntimeError):
        UniMoEAudio(allow_random=True, device="cuda")


def test_unported_options_raise():
    """Quantized serving modes and checkpoint loading come with later
    slices; without random weights there is nothing to serve yet."""
    for mode in (True, "int8", "int4", "int4-gptq"):
        with pytest.raises(NotImplementedError):
            UniMoEAudio(allow_random=True, device="cpu", serving_mode=mode)
    with pytest.raises(NotImplementedError):
        UniMoEAudio("/nonexistent", allow_random=True, device="cpu")
    with pytest.raises(ValueError):
        UniMoEAudio(device="cpu")


def test_port_imports_no_jax():
    """In a fresh interpreter (this test process has JAX loaded by
    conftest.py), importing the port loads no jax* or unimoe_audio_tpu*
    module."""
    code = (
        "import sys\n"
        "import unimoe_audio_torch, unimoe_audio_torch.api\n"
        "import unimoe_audio_torch.core.bridge, unimoe_audio_torch.ops.flash_attention\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'unimoe_audio_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
