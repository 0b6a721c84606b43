"""Causal GQA flash-attention forward: the hand-written CUDA kernel
`csrc/flash_attention_fwd.cu` and its plain PyTorch version.

Replaces the Pallas TPU kernel `_flash_kernel`
(`unimoe_audio_tpu/ops/flash_attention.py:30-97`, reached through
`_flash_forward` and the public `flash_attention` :386-403), which runs the
prefill of the generate loop.  Layout as there: q [B, H, T, Dh],
k/v [B, KV, S, Dh], kv_valid [B, S] (1 = attendable); query head h reads kv
head h // (H / KV); query row i sits at key position i + S - T.  A row with
no attendable key outputs 0.

What bounds it on the H100: at prefill shapes (B = 8, H = 16, KV = 2,
T = S = 128, Dh = 128) one call reads and writes about 9 MB and does about
0.5 GFLOP, so it is bound by memory traffic and launch latency.  The kernel
keeps every score tile in shared memory (the [T, S] matrix never reaches
device memory) and reads each K/V tile once per query tile; see the source
for the design.

`flash_attention` takes a CPU tensor to the plain version and a CUDA tensor
to the kernel, with no fallback between them.  `flash_attention.launches`
counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def flash_attention_reference(q, k, v, kv_valid, causal: bool = True,
                              return_stats: bool = False):
    """Plain PyTorch twin of `_reference_attention`
    (`unimoe_audio_tpu/ops/flash_attention.py:100-116`): scores in the input
    dtype, softmax in f32, probabilities cast back to the input dtype, dead
    rows 0.  With return_stats also the kernel's residuals m, l [B*H, T] f32
    (max of the masked scaled scores; Σ exp(s - m), 1e30 for dead rows)."""
    B, H, T, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    g = H // KV
    kk = k.repeat_interleave(g, dim=1)
    vv = v.repeat_interleave(g, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", q, kk).float() * Dh ** -0.5
    allowed = (kv_valid[:, None, None, :] > 0).expand(B, H, T, S)
    if causal:
        tri = torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
        allowed = allowed & tri
    s = torch.where(allowed, s, torch.full_like(s, NEG_INF))
    live = allowed.any(dim=-1, keepdim=True)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    p = torch.where(live, p, torch.zeros_like(p))
    out = torch.einsum("bhts,bhsd->bhtd", p, vv)
    if not return_stats:
        return out
    m = s.amax(dim=-1)
    l = torch.exp(s - m[..., None]).sum(dim=-1)
    l = torch.where(live[..., 0], l, torch.full_like(l, -NEG_INF))
    return out, m.reshape(B * H, T), l.reshape(B * H, T)


def _check(q, k, v, kv_valid):
    B, H, T, Dh = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh:
        raise ValueError(f"k/v must be [B, KV, S, Dh]; got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    KV, S = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if Dh not in (64, 128):
        raise ValueError(f"the flash kernel takes Dh in (64, 128), got {Dh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"the flash kernel takes bf16; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the flash kernel takes contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if kv_valid.shape != (B, S) or kv_valid.dtype != torch.int32 \
            or not kv_valid.is_contiguous():
        raise ValueError("kv_valid must be a contiguous int32 [B, S] tensor")
    if B * H > 65535:
        raise ValueError(f"B*H={B * H} exceeds the kernel's grid limit")
    if not (q.device == k.device == v.device == kv_valid.device):
        raise ValueError("q, k, v and kv_valid must be on one device")
    return B, H, KV, T, S, Dh


def _flash_forward_cuda(q, k, v, kv_valid, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    from .cuda_build import load

    B, H, KV, T, S, Dh = _check(q, k, v, kv_valid)
    o = torch.empty_like(q)
    m = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    l = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    if T == 0:
        return o, m, l
    fn = load("flash_attention_fwd").flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
                 o.data_ptr(), m.data_ptr(), l.data_ptr(),
                 B, H, KV, T, S, Dh, int(causal), Dh ** -0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention.launches += 1
    return o, m, l


def flash_attention(q, k, v, kv_valid: Optional[torch.Tensor] = None, *,
                    causal: bool = True, return_stats: bool = False):
    """Attention output [B, H, T, Dh]; with return_stats also the softmax
    residuals m, l [B*H, T] f32.  The kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if kv_valid is None:
        kv_valid = torch.ones(q.shape[0], k.shape[2], dtype=torch.int32, device=q.device)
    if q.is_cuda:
        o, m, l = _flash_forward_cuda(q, k, v, kv_valid, causal)
        return (o, m, l) if return_stats else o
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return flash_attention_reference(q, k, v, kv_valid, causal, return_stats=return_stats)


flash_attention.launches = 0
