"""Causal GQA flash attention with exact gradients: the hand-written CUDA
kernels `csrc/flash_attention_fwd.cu` (forward) and
`csrc/flash_attention_bwd.cu` (dq; dk and dv) for bf16, and
`csrc/flash_attention_f32.cu` (forward) and `csrc/flash_attention_bwd_f32.cu`
(dq; dk and dv) for f32, their plain PyTorch versions, and the autograd
function that joins them.

Replaces the Pallas TPU kernels of `unimoe_audio_tpu/ops/flash_attention.py`:
`_flash_kernel` (:30-97, the forward, reached through `_flash_forward` and
the public `flash_attention` :386-403), and the two backward kernels of its
custom VJP, `_flash_bwd_dq_kernel` (:150-205) and `_flash_bwd_dkv_kernel`
(:208-275).  Layout as there: q [B, H, T, Dh], k/v [B, KV, S, Dh],
kv_valid [B, S] (1 = attendable); query head h reads kv head h // (H / KV);
query row i sits at key position i + S - T.  A row with no attendable key
outputs 0 and gets no gradient.

What bounds them on the H100: at prefill shapes (B = 8, H = 16, KV = 2,
T = S = 128, Dh = 128) a forward moves about 9 MB and does about 0.5 GFLOP,
so it is bound by memory traffic and launch latency; at the training shape
(B = 4, T = S = 2048) each kernel does 34-138 GFLOP on about 70 MB and is
bound by the tensor cores.  The [T, S] matrices never reach device memory:
the bf16 kernels keep their score tiles in registers (TMA-fed wgmma).  In
f32, as the JAX package's kernels compute in the input dtype, the forward
and the two backward kernels run each product on the tensor cores as three
TF32 products (`mma.sync` m16n8k8: hi·hi + hi·lo + lo·hi of each operand
split into hi = tf32(x) and lo = x - hi, which the tensor core reads as
TF32; about 21 bits a product where TF32 alone keeps 11, the building
blocks of `csrc/flash_f32_tf32.cuh`), with the mask, the online softmax
(or its recompute) and dS in f32; see the sources for the designs.

`flash_attention` goes through `FlashAttention`, which takes a CPU tensor to
the plain version and a CUDA tensor to the kernel, with no fallback between
them; its backward runs the two backward kernels on the card and their plain
versions on the CPU.  On the card each wrapper picks the kernel by dtype
(bf16 or f32) and raises for any other.  Each wrapper counts its kernels'
launches: `flash_attention.launches`, `flash_attention_bwd_dq.launches`,
`flash_attention_bwd_dkv.launches` and
`flash_attention_bwd_dkv.reduce_launches` (the GQA sum of the per-head
dk and dv, when H > KV) for bf16, and the same names with an `f32_`
prefix (`flash_attention.f32_launches`, ...) for f32, where the dk/dv
kernel sums the heads itself and `f32_reduce_launches` stays 0.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type scores and softmax statistics are computed in: f32, or f64
    for f64 inputs (gradcheck)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _allowed(kv_valid, T: int, S: int, causal: bool):
    """[B, 1, T, S] bool: key s is attendable by query row t."""
    allowed = (kv_valid[:, None, None, :] > 0)
    if causal:
        tri = torch.ones(T, S, dtype=torch.bool, device=kv_valid.device).tril(S - T)
        allowed = allowed & tri
    return allowed


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
    s = torch.einsum("bhtd,bhsd->bhts", q, kk).to(_acc_dtype(q.dtype)) * Dh ** -0.5
    allowed = _allowed(kv_valid, T, S, causal).expand(B, H, T, S)
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


def _bwd_tiles(q, k, v, do, m, l, dvec, kv_valid, causal):
    """The backward kernels' shared arithmetic on whole matrices: P rebuilt
    from the residuals and dS = where(allowed, P ∘ (dP − D), 0), both
    [B, H, T, S] and rounded to the input dtype, as the kernels round them
    before their products; plus kv expanded to H heads, in the accumulation
    type."""
    B, H, T, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    ct = _acc_dtype(q.dtype)
    kk = k.repeat_interleave(H // KV, dim=1).to(ct)
    vv = v.repeat_interleave(H // KV, dim=1).to(ct)
    s = torch.einsum("bhtd,bhsd->bhts", q.to(ct), kk) * Dh ** -0.5
    allowed = _allowed(kv_valid, T, S, causal)
    linv = 1.0 / l.reshape(B, H, T, 1).to(ct).clamp_min(1e-30)
    p = torch.where(allowed, torch.exp(s - m.reshape(B, H, T, 1).to(ct)) * linv, 0.0)
    dp = torch.einsum("bhtd,bhsd->bhts", do.to(ct), vv)
    ds = torch.where(allowed, p * (dp - dvec.reshape(B, H, T, 1).to(ct)), 0.0)
    return p.to(q.dtype).to(ct), ds.to(q.dtype).to(ct), kk


def flash_attention_bwd_dq_reference(q, k, v, do, m, l, dvec, kv_valid, causal: bool = True):
    """Plain version of the dq kernel (the formulas of `_flash_bwd_dq_kernel`):
    dq = scale · dS · K, accumulated in f32."""
    _, ds, kk = _bwd_tiles(q, k, v, do, m, l, dvec, kv_valid, causal)
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kk) * q.shape[-1] ** -0.5
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_reference(q, k, v, do, m, l, dvec, kv_valid, causal: bool = True):
    """Plain version of the dk/dv kernel (the formulas of
    `_flash_bwd_dkv_kernel` plus the GQA group-sum): per query head
    dv_h = Pᵀ · dO and dk_h = scale · dSᵀ · Q, accumulated in f32 and
    rounded to the input dtype, then summed in f32 over each kv head's
    H / KV query heads, as the JAX package rounds each head's dk, dv
    before its sum (:372-379)."""
    B, H, T, Dh = q.shape
    KV, S = k.shape[1], k.shape[2]
    p, ds, _ = _bwd_tiles(q, k, v, do, m, l, dvec, kv_valid, causal)
    ct = p.dtype
    dk = torch.einsum("bhts,bhtd->bhsd", ds, q.to(ct)) * Dh ** -0.5
    dv = torch.einsum("bhts,bhtd->bhsd", p, do.to(ct))
    dk = dk.to(k.dtype).to(ct).reshape(B, KV, H // KV, S, Dh).sum(dim=2)
    dv = dv.to(v.dtype).to(ct).reshape(B, KV, H // KV, S, Dh).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


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
        if t.dtype not in KERNEL_DTYPES or t.dtype != q.dtype:
            raise ValueError(f"the flash kernels take bf16 or f32, one dtype for q, k and v; "
                             f"{name} is {t.dtype}, q {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the flash kernel takes contiguous tensors; {name} is not")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if kv_valid.shape != (B, S) or kv_valid.dtype != torch.int32 \
            or not kv_valid.is_contiguous():
        raise ValueError("kv_valid must be a contiguous int32 [B, S] tensor")
    if not (q.device == k.device == v.device == kv_valid.device):
        raise ValueError("q, k, v and kv_valid must be on one device")
    return B, H, KV, T, S, Dh


# The dtypes the kernels take: bf16 (flash_attention_fwd.cu,
# flash_attention_bwd.cu) and f32 (flash_attention_f32.cu,
# flash_attention_bwd_f32.cu).
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# Rows of a CTA's tile by dtype and kernel: K1's and K2's query rows, K3's
# keys.  The grids are (B*H, ceil(T / rows)) for K1 and K2 and
# (B*H or, in f32, B*KV, ceil(S / keys)) for K3.
BLOCK_ROWS = {torch.bfloat16: {"fwd": 128, "dq": 128, "dkv": 128},
              torch.float32: {"fwd": 128, "dq": 128, "dkv": 64}}


def _check_fwd(q, k, v, kv_valid):
    B, H, KV, T, S, Dh = _check(q, k, v, kv_valid)
    rows = BLOCK_ROWS[q.dtype]["fwd"]
    if B * H >= 2 ** 31 or -(-T // rows) > 65535:
        raise ValueError(f"B*H={B * H}, T={T} exceed the forward kernel's grid limits "
                         f"(B*H < 2**31, ceil(T / {rows}) <= 65535)")
    return B, H, KV, T, S, Dh


def _check_bwd(q, k, v, do, m, l, dvec, kv_valid):
    B, H, KV, T, S, Dh = _check(q, k, v, kv_valid)
    rows, keys = BLOCK_ROWS[q.dtype]["dq"], BLOCK_ROWS[q.dtype]["dkv"]
    if B * H >= 2 ** 31 or max(-(-T // rows), -(-S // keys)) > 65535:
        raise ValueError(f"B*H={B * H}, T={T}, S={S} exceed the backward kernels' grid limits "
                         f"(B*H < 2**31, ceil(T / {rows}) and ceil(S / {keys}) <= 65535)")
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous() \
            or do.data_ptr() % 16:
        raise ValueError("dO must be a contiguous, 16-byte aligned tensor shaped and typed as q")
    for name, t in (("m", m), ("l", l), ("D", dvec)):
        if t.shape != (B * H, T) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 [B*H, T] tensor")
    if not (q.device == do.device == m.device == l.device == dvec.device):
        raise ValueError("all inputs must be on one device")
    return B, H, KV, T, S, Dh


_ENCODE_FAILED = 10000      # csrc/hopper_tma.cuh: + the CUresult of a failed encode


@functools.cache
def _entry(source: str, name: str, n_ptrs: int):
    """The C entry `name` of csrc/<source>.cu, bound once: n_ptrs pointers,
    7 ints, the scale and the stream."""
    from .cuda_build import load

    fn = getattr(load(source), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _call(source: str, name: str, n_ptrs: int, *args) -> None:
    """Launch the C entry `name` of csrc/<source>.cu on the current stream
    (n_ptrs pointers, then 7 ints and the scale); raise if the launch
    failed."""
    err = _entry(source, name, n_ptrs)(*args, torch.cuda.current_stream().cuda_stream)
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"{name}: cuTensorMapEncodeTiled failed: CUresult {err - _ENCODE_FAILED}")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def _kernel(q, bf16_source: str, f32_source: str, name: str) -> Tuple[str, str, str]:
    """(source, C entry, counter prefix) of the kernel for q's dtype: the
    bf16 source's entry `name`, or `name`_f32 of the f32 source."""
    if q.dtype == torch.float32:
        return f32_source, name + "_f32", "f32_"
    return bf16_source, name, ""


def _count(fn, prefix: str, counter: str = "launches") -> None:
    setattr(fn, prefix + counter, getattr(fn, prefix + counter) + 1)


def _flash_forward_cuda(q, k, v, kv_valid, causal: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, H, KV, T, S, Dh = _check_fwd(q, k, v, kv_valid)
    o = torch.empty_like(q)
    m = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    l = torch.empty((B * H, T), dtype=torch.float32, device=q.device)
    if T == 0:
        return o, m, l
    source, entry, prefix = _kernel(q, "flash_attention_fwd", "flash_attention_f32",
                                    "flash_attention_fwd")
    with torch.cuda.device(q.device):
        _call(source, entry, 7,
              q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_valid.data_ptr(),
              o.data_ptr(), m.data_ptr(), l.data_ptr(),
              B, H, KV, T, S, Dh, int(causal), Dh ** -0.5)
    _count(flash_attention, prefix)
    return o, m, l


def _cpu_only(q) -> None:
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def flash_attention_bwd_dq(q, k, v, do, m, l, dvec, kv_valid, causal: bool = True):
    """dq [B, H, T, Dh] from the forward's inputs, dO, its residuals m, l
    and D = rowsum(dO ∘ O) ([B*H, T] f32 each).  The kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if not q.is_cuda:
        _cpu_only(q)
        return flash_attention_bwd_dq_reference(q, k, v, do, m, l, dvec, kv_valid, causal)
    B, H, KV, T, S, Dh = _check_bwd(q, k, v, do, m, l, dvec, kv_valid)
    if T == 0 or S == 0:
        return torch.zeros_like(q)
    dq = torch.empty_like(q)
    source, entry, prefix = _kernel(q, "flash_attention_bwd", "flash_attention_bwd_f32",
                                    "flash_attention_bwd_dq")
    with torch.cuda.device(q.device):
        _call(source, entry, 9,
              q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(),
              l.data_ptr(), dvec.data_ptr(), kv_valid.data_ptr(), dq.data_ptr(),
              B, H, KV, T, S, Dh, int(causal), Dh ** -0.5)
    _count(flash_attention_bwd_dq, prefix)
    return dq


def flash_attention_bwd_dkv(q, k, v, do, m, l, dvec, kv_valid, causal: bool = True):
    """(dk, dv) [B, KV, S, Dh], GQA group-summed, from the same inputs as
    `flash_attention_bwd_dq`.  The kernel on a CUDA tensor, the plain
    version on a CPU tensor.  On the card in bf16 with H > KV the kernel
    writes each query head's dk and dv into a [2, B*H, S, Dh] scratch
    tensor and a second kernel sums each kv head's H / KV of them in head
    order; in f32 one kernel walks a kv head's query heads in head order
    and writes the sums."""
    if not q.is_cuda:
        _cpu_only(q)
        return flash_attention_bwd_dkv_reference(q, k, v, do, m, l, dvec, kv_valid, causal)
    B, H, KV, T, S, Dh = _check_bwd(q, k, v, do, m, l, dvec, kv_valid)
    if T == 0 or S == 0:
        return torch.zeros_like(k), torch.zeros_like(v)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    source, entry, prefix = _kernel(q, "flash_attention_bwd", "flash_attention_bwd_f32",
                                    "flash_attention_bwd_dkv")
    f32 = q.dtype == torch.float32
    part = (torch.empty((2, B * H, S, Dh), dtype=k.dtype, device=k.device)
            if H > KV and not f32 else None)
    scratch = () if f32 else (None if part is None else part.data_ptr(),)
    with torch.cuda.device(q.device):
        _call(source, entry, 10 + len(scratch),
              q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), m.data_ptr(),
              l.data_ptr(), dvec.data_ptr(), kv_valid.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              *scratch, B, H, KV, T, S, Dh, int(causal), Dh ** -0.5)
    _count(flash_attention_bwd_dkv, prefix)
    if part is not None:
        _count(flash_attention_bwd_dkv, prefix, "reduce_launches")
    return dk, dv


def softmax_residual_rowsum(do, o) -> torch.Tensor:
    """D = rowsum(dO ∘ O) [B*H, T] in f32 (f64 for f64 inputs), computed
    outside the kernels as in the JAX package (:307)."""
    B, H, T, _ = o.shape
    ct = _acc_dtype(o.dtype)
    return (do.to(ct) * o.to(ct)).sum(dim=-1).reshape(B * H, T)


class FlashAttention(torch.autograd.Function):
    """Flash attention with the JAX package's custom VJP
    (`_flash_with_vjp`, :119-143): the forward saves q, k, v, kv_valid, o
    and the residuals m, l; the backward runs the dq and dk/dv kernels (the
    plain versions for CPU tensors).  Returns (o, m, l); m and l carry no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal: bool):
        if q.is_cuda:
            o, m, l = _flash_forward_cuda(q, k, v, kv_valid, causal)
        else:
            _cpu_only(q)
            o, m, l = flash_attention_reference(q, k, v, kv_valid, causal, return_stats=True)
        ctx.save_for_backward(q, k, v, kv_valid, o, m, l)
        ctx.causal = causal
        ctx.mark_non_differentiable(m, l)
        return o, m, l

    @staticmethod
    def backward(ctx, do, _dm, _dl):
        q, k, v, kv_valid, o, m, l = ctx.saved_tensors
        do = do.contiguous()
        dvec = softmax_residual_rowsum(do, o)
        dq = flash_attention_bwd_dq(q, k, v, do, m, l, dvec, kv_valid, ctx.causal)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, m, l, dvec, kv_valid, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, kv_valid: Optional[torch.Tensor] = None, *,
                    causal: bool = True, return_stats: bool = False):
    """Attention output [B, H, T, Dh]; with return_stats also the softmax
    residuals m, l [B*H, T] f32.  Through `FlashAttention`: the kernel on a
    CUDA tensor, the plain version on a CPU tensor; a graph is recorded only
    when q, k or v requires a gradient."""
    if kv_valid is None:
        kv_valid = torch.ones(q.shape[0], k.shape[2], dtype=torch.int32, device=q.device)
    o, m, l = FlashAttention.apply(q, k, v, kv_valid, causal)
    return (o, m, l) if return_stats else o


flash_attention.launches = flash_attention.f32_launches = 0
flash_attention_bwd_dq.launches = flash_attention_bwd_dq.f32_launches = 0
flash_attention_bwd_dkv.launches = flash_attention_bwd_dkv.f32_launches = 0
flash_attention_bwd_dkv.reduce_launches = flash_attention_bwd_dkv.f32_reduce_launches = 0
