"""Blockwise 8-bit Adam moments — counterpart of
`unimoe_audio_tpu/train/qmoment.py`.

The offload and stream trainers stream their Adam moments between host
memory and the card every step.  Stored as log-spaced uint8 codes with one
f32 absmax per BLOCK values, a moment costs 1 byte and 1/512 of a byte of
scale instead of 4, at a worst-case half-step relative error of about 5.6 %
(Dettmers et al. 2021, "8-bit Optimizers via Block-wise Quantization").

The codes are closed-form: log2-spaced inside each block's
[absmax · 2^-R, absmax] range, so encode and decode are log2 / exp2 / round
with no table lookup.  Layout of a flat f32 vector zero-padded to BLOCK:

  unsigned (nu): code 0 = exact zero; 1..255 over R_UNSIGNED = 40 octaves
                 (values below the floor clamp up to absmax · 2^-40, which
                 only shrinks the Adam update);
  signed (mu):   code 0 = exact zero; 1..127 negative magnitudes, 128..255
                 positive, each over R_SIGNED = 20 octaves.

Stochastic rounding (`key`): under b2 = 0.999 nu decays by 0.1 % a step,
far below the ~11.6 % code step, so round-to-nearest would pin it once
gradients shrink.  floor(y + u) with u uniform in (0, 1) is unbiased in the
log domain.  It is bounded by ⌈y⌉: in f32, 254 + u rounds to 255 for u
within 2^-17 of 1, about once in 2^17 block maxima.  XLA's f32 → uint8
cast saturates the code 256 to 255, torch's wraps it to 0, which would
store a block's largest nu as exact zero (its Adam step then divided by
eps alone); and 1 + ⌊126 + u⌋ = 128 turns a block's most negative mu into
the positive floor, in the JAX package's formula too.  The uniforms come from the port's counter hash
(`generate/sampler.counter_uniform`), keyed on (SR_SEED, step, leaf) and
the element index: the same codes on the card and the CPU, and a resumed
run repeats bit for bit.  (The JAX package draws them from `jax.random`;
the draws differ, their distribution does not.)

Elementwise work: plain torch, as it was an XLA fusion in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..generate.sampler import counter_uniform, mix32

BLOCK = 2048
R_SIGNED = 20.0
R_UNSIGNED = 40.0
SR_SEED = 0x8B17          # the fixed seed of the stochastic-rounding keys
_TINY = 1e-38             # log2 guard; f32's smallest normal is about 1.2e-38


def padded_len(n: int) -> int:
    return -(-max(n, 1) // BLOCK) * BLOCK


def rounding_key(step: int, leaf: int) -> Tuple[int, int, int]:
    """The stochastic-rounding key of one moment vector: (SR_SEED, the
    applied-step count, the leaf's index)."""
    return (SR_SEED, int(step), int(leaf))


def _uniforms(key: Tuple[int, int, int], n: int, device) -> torch.Tensor:
    """n uniforms in (0, 1), f32, one per element index."""
    seed, step, leaf = (torch.tensor([v], dtype=torch.int64, device=device) for v in key)
    k = mix32(mix32(mix32(seed) ^ step) ^ leaf)
    return counter_uniform(k, torch.arange(n, device=device))[0]


def quantize_blockwise(x: torch.Tensor, *, signed: bool,
                       key: Optional[Tuple[int, int, int]] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32[n_pad] (n_pad % BLOCK == 0) → (codes uint8[n_pad], absmax
    f32[n_pad / BLOCK]).  key=None rounds to nearest (half to even, as
    jnp.round); a `rounding_key` rounds stochastically."""
    xb = x.reshape(-1, BLOCK).float()
    amax = xb.abs().amax(dim=1, keepdim=True)
    tiny = torch.tensor(_TINY, dtype=torch.float32, device=x.device)
    l = torch.log2(torch.maximum(xb.abs(), tiny) / torch.maximum(amax, tiny))   # <= 0
    if key is None:
        rnd = torch.round
    else:
        u = _uniforms(key, xb.numel(), x.device).reshape(xb.shape)
        # ∈ {⌊y⌋, ⌈y⌉}: y + u rounds in f32, and at an integral y (the top
        # codes, 254 and 126) a u within 2^-17 of 1 would round it up to
        # y + 1 without the bound by ⌈y⌉.
        rnd = lambda y: torch.minimum(torch.floor(y + u), torch.ceil(y))   # noqa: E731
    if signed:
        t = torch.clamp(1.0 + l / R_SIGNED, 0.0, 1.0)
        c = torch.where(xb >= 0, 128.0 + rnd(127.0 * t), 1.0 + rnd(126.0 * t))
    else:
        c = 1.0 + rnd(254.0 * torch.clamp(1.0 + l / R_UNSIGNED, 0.0, 1.0))
    c = torch.where(xb == 0.0, torch.zeros_like(c), c)
    return c.to(torch.uint8).reshape(-1), amax[:, 0]


def dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor, *,
                         signed: bool) -> torch.Tensor:
    """(codes uint8[n_pad], absmax f32[n_pad / BLOCK]) → f32[n_pad]."""
    c = codes.reshape(-1, BLOCK).float()
    amax = scale[:, None].float()
    if signed:
        is_pos = c >= 128.0
        t = torch.where(is_pos, (c - 128.0) / 127.0, (c - 1.0) / 126.0)
        mag = amax * torch.exp2(R_SIGNED * (t - 1.0))
        x = torch.where(is_pos, mag, -mag)
    else:
        t = (c - 1.0) / 254.0
        x = amax * torch.exp2(R_UNSIGNED * (t - 1.0))
    return torch.where(c == 0.0, torch.zeros_like(x), x).reshape(-1)
