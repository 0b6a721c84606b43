"""DAC neural codec (descript-audio-codec, 16 kHz config) in PyTorch:
encoder, residual vector quantizer and decoder — counterpart of
`unimoe_audio_tpu/codec/dac.py`.

Weight-norm convs are stored folded (one `w`) in torch layout
[out, in, k] (transposed convs [in, out, k]), the JAX package's layout, so
the bridge from its param pytree only copies.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class DACConfig:
    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 5, 8)
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 5, 4, 2)
    n_codebooks: int = 12
    codebook_size: int = 1024
    codebook_dim: int = 8
    sample_rate: int = 16000

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.encoder_rates))

    @property
    def latent_dim(self) -> int:
        return self.encoder_dim * (2 ** len(self.encoder_rates))


def tiny_dac_config() -> DACConfig:
    """Miniature DAC for tests."""
    return DACConfig(
        encoder_dim=8, encoder_rates=(2, 4), decoder_dim=32, decoder_rates=(4, 2),
        n_codebooks=4, codebook_size=32, codebook_dim=4, sample_rate=16000,
    )


def conv1d(x, w, b=None, *, stride=1, padding=0, dilation=1):
    """x: [B, C, T]; w: [out, in, k]."""
    return F.conv1d(x, w, b, stride=stride, padding=padding, dilation=dilation)


def conv_transpose1d(x, w, b=None, *, stride=1, padding=0, output_padding=0):
    """torch ConvTranspose1d; w: [in, out, k]."""
    return F.conv_transpose1d(x, w, b, stride=stride, padding=padding,
                              output_padding=output_padding)


def snake(x, alpha):
    """Snake activation x + sin²(αx)/α, in f32; alpha [1, C, 1]."""
    a = alpha.float()
    xf = x.float()
    return (xf + (1.0 / (a + 1e-9)) * torch.sin(a * xf).square()).to(x.dtype)


def residual_unit(p: Dict, x, dilation: int):
    """Snake → k7 dilated conv → Snake → k1 conv, residual add."""
    y = snake(x, p["snake1_alpha"])
    y = conv1d(y, p["conv1_w"], p["conv1_b"], padding=((7 - 1) * dilation) // 2,
               dilation=dilation)
    y = snake(y, p["snake2_alpha"])
    y = conv1d(y, p["conv2_w"], p["conv2_b"])
    return x + y


def encoder_block(p: Dict, x, stride: int):
    for i, dil in enumerate((1, 3, 9)):
        x = residual_unit(p["res"][i], x, dil)
    x = snake(x, p["snake_alpha"])
    return conv1d(x, p["conv_w"], p["conv_b"], stride=stride, padding=math.ceil(stride / 2))


def decoder_block(p: Dict, x, stride: int):
    x = snake(x, p["snake_alpha"])
    x = conv_transpose1d(x, p["convt_w"], p["convt_b"], stride=stride,
                         padding=math.ceil(stride / 2), output_padding=stride % 2)
    for i, dil in enumerate((1, 3, 9)):
        x = residual_unit(p["res"][i], x, dil)
    return x


def dac_encoder(params: Dict, audio: torch.Tensor, cfg: DACConfig) -> torch.Tensor:
    """audio [B, 1, T] → latents [B, latent_dim, T / hop]."""
    x = conv1d(audio, params["conv_in_w"], params["conv_in_b"], padding=3)
    for i, stride in enumerate(cfg.encoder_rates):
        x = encoder_block(params["blocks"][i], x, stride)
    x = snake(x, params["snake_out_alpha"])
    return conv1d(x, params["conv_out_w"], params["conv_out_b"], padding=1)


def rvq_encode(params: Dict, z: torch.Tensor, cfg: DACConfig) -> torch.Tensor:
    """Latents [B, D, T] → codes [B, n_codebooks, T] (DAC's VectorQuantize):
    per codebook, project the residual to codebook_dim, take the entry of
    largest cosine similarity (the nearest after L2-normalising both sides;
    the first of equal maxima), and subtract its out-projection from the
    residual.  In f32: a near tie decided otherwise changes every later
    codebook of that frame."""
    residual = z
    codes = []
    for i in range(cfg.n_codebooks):
        q = params["quantizers"][i]
        enc = conv1d(residual, q["in_proj_w"], q["in_proj_b"]).transpose(1, 2)   # [B, T, d_cb]
        enc_n = enc / (torch.linalg.vector_norm(enc, dim=-1, keepdim=True) + 1e-12)
        cb = q["codebook"]                                                       # [K, d_cb]
        cb_n = cb / (torch.linalg.vector_norm(cb, dim=-1, keepdim=True) + 1e-12)
        idx = torch.einsum("btd,kd->btk", enc_n, cb_n).argmax(dim=-1)            # [B, T]
        codes.append(idx)
        z_q = conv1d(cb[idx].transpose(1, 2), q["out_proj_w"], q["out_proj_b"])
        residual = residual - z_q
    return torch.stack(codes, dim=1)


def rvq_decode(params: Dict, codes: torch.Tensor, cfg: DACConfig) -> torch.Tensor:
    """codes [B, n_codebooks, T] → latents [B, D, T] (quantizer.from_codes).
    Codes past the codebook are clamped to [0, codebook_size - 1], as the
    JAX package's gather clamps them."""
    z_q = None
    codes = codes.long().clamp(0, cfg.codebook_size - 1)
    for i in range(cfg.n_codebooks):
        q = params["quantizers"][i]
        z_p = q["codebook"][codes[:, i]].transpose(1, 2)            # [B, d_cb, T]
        z_q_i = conv1d(z_p, q["out_proj_w"], q["out_proj_b"])
        z_q = z_q_i if z_q is None else z_q + z_q_i
    return z_q


def dac_decoder(params: Dict, z: torch.Tensor, cfg: DACConfig) -> torch.Tensor:
    """latents [B, D, T] → audio [B, 1, T·hop]."""
    x = conv1d(z, params["conv_in_w"], params["conv_in_b"], padding=3)
    for i, stride in enumerate(cfg.decoder_rates):
        x = decoder_block(params["blocks"][i], x, stride)
    x = snake(x, params["snake_out_alpha"])
    x = conv1d(x, params["conv_out_w"], params["conv_out_b"], padding=3)
    return torch.tanh(x)


def dac_preprocess(audio: torch.Tensor, cfg: DACConfig) -> torch.Tensor:
    """Right-pad [B, 1, T] with zeros to a multiple of the hop."""
    pad = (cfg.hop_length - audio.shape[-1] % cfg.hop_length) % cfg.hop_length
    return F.pad(audio, (0, pad)) if pad else audio


def dac_encode(params: Dict, audio: torch.Tensor, cfg: DACConfig) -> torch.Tensor:
    """[B, 1, T] waveform → [B, n_codebooks, ceil(T / hop)] codes."""
    z = dac_encoder(params["encoder"], dac_preprocess(audio, cfg), cfg)
    return rvq_encode(params["quantizer"], z, cfg)


def dac_decode(params: Dict, codes: torch.Tensor, cfg: DACConfig) -> torch.Tensor:
    """[B, n_codebooks, T] codes → [B, 1, T·hop] waveform."""
    return dac_decoder(params["decoder"], rvq_decode(params["quantizer"], codes, cfg), cfg)


def init_dac_params(cfg: DACConfig, *, seed: int = 0, device="cuda") -> Dict:
    """Random f32 encoder, quantizer and decoder weights made on `device`
    (uniform fan-in scaled convs, unit snake alphas, normal codebooks), laid
    out as `init_dac_params` in the JAX package.  The decoder side is drawn
    first, then the encoder and the quantizers' in-projections."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def uni(shape, scale):
        t = torch.rand(*shape, generator=gen, device=device)
        return t.mul_(2 * scale).sub_(scale)

    def conv(out_ch, in_ch, k):
        scale = (in_ch * k) ** -0.5
        return uni((out_ch, in_ch, k), scale), uni((out_ch,), scale)

    def ones(d):
        return torch.ones(1, d, 1, device=device)

    def res_unit(dim):
        w1, b1 = conv(dim, dim, 7)
        w2, b2 = conv(dim, dim, 1)
        return {"snake1_alpha": ones(dim), "conv1_w": w1, "conv1_b": b1,
                "snake2_alpha": ones(dim), "conv2_w": w2, "conv2_b": b2}

    quantizers = []
    for _ in range(cfg.n_codebooks):
        wo, bo = conv(cfg.latent_dim, cfg.codebook_dim, 1)
        cb = torch.randn(cfg.codebook_size, cfg.codebook_dim, generator=gen, device=device)
        quantizers.append({"out_proj_w": wo, "out_proj_b": bo, "codebook": cb})

    d = cfg.decoder_dim
    w_in, b_in = conv(d, cfg.latent_dim, 7)
    blocks = []
    for stride in cfg.decoder_rates:
        out_d = d // 2
        blocks.append({
            "snake_alpha": ones(d),
            "convt_w": uni((d, out_d, 2 * stride), (d * 2 * stride) ** -0.5),
            "convt_b": torch.zeros(out_d, device=device),
            "res": [res_unit(out_d) for _ in range(3)],
        })
        d = out_d
    w_out, b_out = conv(1, d, 7)
    decoder = {"conv_in_w": w_in, "conv_in_b": b_in, "blocks": blocks,
               "snake_out_alpha": ones(d), "conv_out_w": w_out, "conv_out_b": b_out}

    d = cfg.encoder_dim
    w_in, b_in = conv(d, 1, 7)
    enc_blocks = []
    for stride in cfg.encoder_rates:
        res = [res_unit(d) for _ in range(3)]
        w, b = conv(2 * d, d, 2 * stride)
        enc_blocks.append({"res": res, "snake_alpha": ones(d), "conv_w": w, "conv_b": b})
        d *= 2
    w_out, b_out = conv(cfg.latent_dim, d, 3)
    encoder = {"conv_in_w": w_in, "conv_in_b": b_in, "blocks": enc_blocks,
               "snake_out_alpha": ones(d), "conv_out_w": w_out, "conv_out_b": b_out}
    for q in quantizers:
        q["in_proj_w"], q["in_proj_b"] = conv(cfg.codebook_dim, cfg.latent_dim, 1)
    return {"encoder": encoder, "quantizer": {"quantizers": quantizers}, "decoder": decoder}
