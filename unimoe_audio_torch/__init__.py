"""UniMoE-Audio in PyTorch for NVIDIA Hopper (H100).

A port of `unimoe_audio_tpu` (the JAX reference, kept beside it): the same
module names and public functions, in PyTorch, with the TPU's Pallas
kernels rewritten by hand for sm_90a.  This package imports neither JAX
nor the JAX package.  Entry point: `unimoe_audio_torch.api.UniMoEAudio`,
or `load_model(path, ...)`.

Package map:
  config     dataclass configs, read from and written to HF config.json
  codec      the DAC codec, the delay pattern, wav I/O, the host library
  moe        the Top-P DCMoE router and its dense / packed / ep / gmm dispatch
  models     the decoder stack, the vision tower, the codec heads
  generate   the decode loop and sampler, streaming, speculative decoding
  ops        the hand-written CUDA kernels (flash attention, grouped GEMMs),
             int8 / int4 quantization, GPTQ
  parallel   the (data, expert, model) mesh, its collectives, multi-process
             start-up
  train      the trainers, data pipeline, surgery, resharding, PEFT, the CLI
  core       checkpoints, the weight converters, the HF export, snapshots
  apps       the inference and serve CLIs, batching, the studio
  utils      profiling and timing

Importing the package loads the configs only (no torch, no CUDA); a
one-line banner goes to stderr unless UNIMOE_AUDIO_QUIET is set.
"""

import os

__version__ = "0.1.0"

from .config import TextMoEConfig, UniMoEAudioConfig, VisionConfig, tiny_test_config


def get_model_info():
    """A summary dict, as the JAX package's `get_model_info`."""
    return {
        "name": "UniMoE-Audio-Torch",
        "version": __version__,
        "tasks": ["text_to_speech", "text_to_music", "video_text_to_music"],
        "backend": "torch/cuda",
        "codec": "DAC 16 kHz, 12 RVQ channels, 50 frames/s",
    }


if not os.environ.get("UNIMOE_AUDIO_QUIET"):
    import sys as _sys

    # stderr, so that a program's JSON lines on stdout stay clean.
    print(f"UniMoE-Audio Torch v{__version__} — torch/cuda · set UNIMOE_AUDIO_QUIET=1 to "
          "silence", file=_sys.stderr)


def load_model(model_path: str, **kwargs):
    """A `UniMoEAudio` for model_path (imported on first call)."""
    from .api import UniMoEAudio

    return UniMoEAudio(model_path, **kwargs)


__all__ = [
    "TextMoEConfig",
    "UniMoEAudioConfig",
    "VisionConfig",
    "tiny_test_config",
    "get_model_info",
    "load_model",
]
