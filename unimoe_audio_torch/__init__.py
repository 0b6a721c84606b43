"""UniMoE-Audio in PyTorch for NVIDIA Hopper (H100).

A port of `unimoe_audio_tpu` (the JAX reference, kept beside it): the same
module names and public functions, in PyTorch, with the TPU's Pallas
kernels rewritten by hand for sm_90a.  This package imports neither JAX
nor the JAX package.  Entry point: `unimoe_audio_torch.api.UniMoEAudio`.
"""

__version__ = "0.1.0"
