"""Grouped matrix products for the gmm MoE dispatch: the hand-written CUDA
kernels `csrc/grouped_gemm.cu`, their plain PyTorch versions, and the
autograd function that joins them.

Replaces the Pallas TPU kernels of the megablox library as `moe_ffn_gmm`
(`unimoe_audio_tpu/moe/dispatch.py:274-371`) uses them: `gmm`
(`jax/experimental/pallas/ops/tpu/megablox/gmm.py:314`, K4), the same
`gmm` with `transpose_rhs=True` in its custom VJP (`megablox/ops.py:80-89`,
K4ᵀ) and `tgmm` (`gmm.py:573`, used at `ops.py:90-99`, K5).

Rows of x are sorted by group: with off_g the prefix sum of `group_sizes`
(clamped to the row count), group g owns rows [off_g, off_g + group_sizes[g]).
A row that no group owns comes out of `gmm` as 0 and adds nothing to
`tgmm`; a group with no rows gets a zero weight gradient.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it takes the plain version; nothing falls back from one to the other.  The
kernels take bf16 operands, plus an f32 dy (the cotangent of K4's f32
output), which they round to bf16 as they load it; they accumulate in f32.
The plain versions round the same way whenever the weights (gmm) or x
(tgmm) are bf16.  Launch counters: `gmm.launches` (K4),
`gmm.transposed_launches` (K4ᵀ), `tgmm.launches` (K5) and
`grouped_matmul.launches` (K4 launched by `grouped_matmul`'s forward).
"""

from __future__ import annotations

import ctypes
import torch

MAX_GROUPS = 64          # the kernels keep the group offsets in shared memory


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _groups(group_sizes: torch.Tensor, rows: int, num_groups: int):
    """(g, start, end) for every group with rows, from host ints (plain
    versions only)."""
    start = 0
    for g, n in enumerate(group_sizes.tolist()[:num_groups]):
        end = min(start + max(int(n), 0), rows)
        if end > start:
            yield g, start, end
        start = end


def gmm_reference(x, w, group_sizes, *, transpose_rhs: bool = False) -> torch.Tensor:
    """Plain version of `gmm`: a loop over the groups, accumulated in f32
    (f64 for f64 inputs); an f32 x meets bf16 weights rounded to bf16, as the
    kernel loads it."""
    ct = _acc_dtype(x.dtype)
    if w.dtype == torch.bfloat16:
        x = x.to(torch.bfloat16)
    n_out = w.shape[1] if transpose_rhs else w.shape[2]
    out = torch.zeros(x.shape[0], n_out, dtype=ct, device=x.device)
    for g, s, e in _groups(group_sizes, x.shape[0], w.shape[0]):
        wg = w[g].to(ct)
        out[s:e] = x[s:e].to(ct) @ (wg.t() if transpose_rhs else wg)
    return out.to(w.dtype) if transpose_rhs else out


def tgmm_reference(x, dy, group_sizes, num_groups: int) -> torch.Tensor:
    """Plain version of `tgmm`: dW[g] = x[rows of g]ᵀ · dy[rows of g], in
    x's dtype, accumulated in f32 (f64 for f64 inputs); with a bf16 x an f32
    dy is rounded to bf16 first, as the kernel loads it."""
    ct = _acc_dtype(x.dtype)
    if x.dtype == torch.bfloat16:
        dy = dy.to(torch.bfloat16)
    out = torch.zeros(num_groups, x.shape[1], dy.shape[1], dtype=ct, device=x.device)
    for g, s, e in _groups(group_sizes, x.shape[0], num_groups):
        out[g] = x[s:e].to(ct).t() @ dy[s:e].to(ct)
    return out.to(x.dtype)


def _cpu_only(x) -> None:
    if x.device.type != "cpu":
        raise ValueError(f"grouped GEMMs run on cuda or cpu, not {x.device}")


def _check_common(name, x, other, group_sizes, num_groups):
    for label, t in (("x", x), ("the second operand", other)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if group_sizes.dtype != torch.int32 or group_sizes.dim() != 1 \
            or group_sizes.numel() != num_groups or not group_sizes.is_contiguous():
        raise ValueError(f"{name}: group_sizes must be a contiguous int32 [{num_groups}] tensor")
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_GROUPS} groups, got {num_groups}")
    if not (x.device == other.device == group_sizes.device):
        raise ValueError(f"{name}: x, the second operand and group_sizes must be on one device")


def _call(entry: str, *args) -> None:
    """Launch a C entry of csrc/grouped_gemm.cu on the current stream (4
    tensors' pointers, then ints); raise if the launch failed."""
    from .cuda_build import load

    fn = getattr(load("grouped_gemm"), entry)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (len(args) - 4) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(args[0].device):
        err = fn(*(t.data_ptr() for t in args[:4]), *args[4:],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def launch_gmm(x, w, group_sizes, out, transpose_rhs: bool) -> None:
    """K4 (or K4ᵀ) into a given output: every row of `out` is written."""
    _call("grouped_gemm_gmm", x, w, group_sizes, out, x.shape[0], x.shape[1], out.shape[1],
          w.shape[0], int(transpose_rhs), int(x.dtype == torch.float32))


def launch_tgmm(x, dy, group_sizes, out) -> None:
    """K5 into a given output: every element of `out` is written."""
    _call("grouped_gemm_tgmm", x, dy, group_sizes, out, x.shape[0], x.shape[1], dy.shape[1],
          out.shape[0], int(dy.dtype == torch.float32))


def gmm(x, w, group_sizes, *, transpose_rhs: bool = False) -> torch.Tensor:
    """out[r] = x[r] · W[g(r)] ([A, K] · [E, K, N] → [A, N]), or with
    transpose_rhs x[r] · W[g(r)]ᵀ ([A, N] · [E, K, N] → [A, K]).  The output
    is f32 (f64 for f64 inputs, plain version only), or W's dtype with
    transpose_rhs (the input gradient's dtype in the VJP)."""
    if not x.is_cuda:
        _cpu_only(x)
        return gmm_reference(x, w, group_sizes, transpose_rhs=transpose_rhs)
    E, K, N = w.shape
    k_in, n_out = (N, K) if transpose_rhs else (K, N)
    want_out = torch.bfloat16 if transpose_rhs else torch.float32
    x_types = (torch.float32, torch.bfloat16) if transpose_rhs else (torch.bfloat16,)
    if w.dtype != torch.bfloat16 or x.dtype not in x_types:
        raise ValueError(
            f"gmm on CUDA takes bf16 operands (an f32 dy with transpose_rhs); got x {x.dtype}, "
            f"w {w.dtype}.  The plain version, gmm_reference, runs on CPU tensors")
    if x.dim() != 2 or x.shape[1] != k_in:
        raise ValueError(f"gmm: x must be [A, {k_in}] for w {tuple(w.shape)} "
                         f"(transpose_rhs={transpose_rhs}); got {tuple(x.shape)}")
    _check_common("gmm", x, w, group_sizes, E)
    out = torch.empty(x.shape[0], n_out, dtype=want_out, device=x.device)
    launch_gmm(x, w, group_sizes, out, transpose_rhs)
    if transpose_rhs:
        gmm.transposed_launches += 1
    else:
        gmm.launches += 1
    return out


def tgmm(x, dy, group_sizes, num_groups: int) -> torch.Tensor:
    """dW[g] = Σ_{r in g} x[r]ᵀ dy[r] ([A, K], [A, N] → [E, K, N]) in x's
    dtype; a group with no rows gets zeros."""
    if not x.is_cuda:
        _cpu_only(x)
        return tgmm_reference(x, dy, group_sizes, num_groups)
    if x.dtype != torch.bfloat16 or dy.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            f"tgmm on CUDA takes a bf16 x and a bf16 or f32 dy; got x {x.dtype}, dy {dy.dtype}.  "
            "The plain version, tgmm_reference, runs on CPU tensors")
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"tgmm: x [A, K] and dy [A, N] must share A; got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}")
    _check_common("tgmm", x, dy, group_sizes, num_groups)
    out = torch.empty(num_groups, x.shape[1], dy.shape[1], dtype=x.dtype, device=x.device)
    launch_tgmm(x, dy, group_sizes, out)
    tgmm.launches += 1
    return out


class GroupedMatmul(torch.autograd.Function):
    """megablox `gmm` with its custom VJP (`megablox/ops.py:22-109`):
    forward K4 (f32 out); backward K4ᵀ for dx (in x's dtype) and K5 for dW
    (in W's dtype); group_sizes gets no gradient."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        out = gmm(x, w, group_sizes)
        if x.is_cuda:
            grouped_matmul.launches += 1
        ctx.save_for_backward(x, w, group_sizes)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm(dy, w, group_sizes, transpose_rhs=True).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = tgmm(x, dy, group_sizes, w.shape[0]).to(w.dtype)
        return dx, dw, None


def grouped_matmul(x, w, group_sizes) -> torch.Tensor:
    """x [A, K] · W[g] [E, K, N] per row group → [A, N] f32, differentiable
    in x and w."""
    return GroupedMatmul.apply(x, w, group_sizes)


gmm.launches = 0
gmm.transposed_launches = 0
tgmm.launches = 0
grouped_matmul.launches = 0
