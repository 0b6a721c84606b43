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
kernels take bf16 operands and accumulate in f32.  An f32 dy (the
cotangent of K4's f32 output) is rounded to bf16, to nearest even, once
before the launch: by `launch_gmm` before K4ᵀ, by `launch_tgmm` before
K5, and by `GroupedMatmul.backward` once for both; the plain
versions round the same way whenever the weights (gmm) or x (tgmm) are
bf16.

K4 has two tile configurations, chosen from the row count A (a host int) by
`gmm_config`: "small" (decode-sized A: 128 x 64 tiles, three CTAs per SM, a
weight stream bound by bytes) and "large" (128 x 256 tiles, bound by the
tensor cores); K4ᵀ, which runs in training only, takes the large one.  K4,
K4ᵀ and K5 are modes of one wgmma kernel, and load through TMA where every
row stride is a multiple of 16 bytes and through cp.async otherwise
(`load_path`).  K5
splits a group's rows into chunks of at most `TGMM_CHUNK_ROWS`; the chunks
of a group with more than one write f32 partials into a workspace
(`tgmm_workspace_slots` of [K, N] each) that a second kernel sums in chunk
order.

Launch counters: `gmm.launches` (K4) with `gmm.launches_by_config`,
`gmm.transposed_launches` (K4ᵀ), `tgmm.launches` (K5),
`tgmm.reduce_launches` (K5's reduction) and `grouped_matmul.launches` (K4
launched by `grouped_matmul`'s forward).
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_GROUPS = 64          # the kernels keep the group offsets in shared memory
GMM_CONFIGS = ("small", "large")
GMM_SMALL_MAX_ROWS = 512  # K4 takes its small-A configuration up to this many rows
TGMM_CHUNK_ROWS = 4096    # K5's largest chunk of one group's rows


def gmm_config(rows: int) -> str:
    """K4's tile configuration for A = rows: "small" streams each group's
    weights over many narrow column tiles (decode), "large" computes wide
    tiles (prefill, training)."""
    return "small" if rows <= GMM_SMALL_MAX_ROWS else "large"


def load_path(*tensors: torch.Tensor) -> str:
    """How the wgmma kernels load these 2-d/3-d operands: "tma" when every
    row stride is a multiple of 16 bytes and every base 16-byte aligned,
    else "cp.async"."""
    ok = all(t.shape[-1] * t.element_size() % 16 == 0 and t.data_ptr() % 16 == 0
             for t in tensors)
    return "tma" if ok else "cp.async"


def tgmm_workspace_slots(rows: int, num_groups: int, chunk_rows: int = TGMM_CHUNK_ROWS) -> int:
    """f32 [K, N] partials K5 may write for A = rows: an upper bound, from
    host ints, on the chunks of the groups that have more than one.  Such a
    group has more than chunk_rows rows, so at most rows // (chunk_rows + 1)
    of them exist, and their chunks number at most ceil(rows / chunk_rows)
    + that count - 1.  0 when no group can have two chunks."""
    if rows <= chunk_rows:
        return 0
    multi = min(num_groups, rows // (chunk_rows + 1))
    return -(-rows // chunk_rows) + multi - 1


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


_ENCODE_FAILED = 10000      # csrc/hopper_tma.cuh: + the CUresult of a failed encode


@functools.cache
def _entry(name: str, n_ptrs: int, n_ints: int):
    """The C entry `name` of csrc/grouped_gemm.cu, bound once: n_ptrs
    pointers, n_ints ints and the stream."""
    from .cuda_build import load

    fn = getattr(load("grouped_gemm"), name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _call(entry: str, tensors, ints) -> None:
    """Launch a C entry of csrc/grouped_gemm.cu on the current stream
    (tensors' pointers, None as a null pointer, then ints); raise if it
    failed."""
    fn = _entry(entry, len(tensors), len(ints))
    with torch.cuda.device(tensors[0].device):
        err = fn(*(None if t is None else t.data_ptr() for t in tensors), *ints,
                 torch.cuda.current_stream().cuda_stream)
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"{entry}: cuTensorMapEncodeTiled failed: "
                           f"CUresult {err - _ENCODE_FAILED}")
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")


def launch_gmm(x, w, group_sizes, out, transpose_rhs: bool, *, config=None) -> None:
    """K4 (in `config`, by default `gmm_config(A)`) or K4ᵀ (the large
    configuration; an f32 x, the cotangent dy, is rounded to bf16 first)
    into a given output: every row of `out` is written."""
    A, E = x.shape[0], w.shape[0]
    if transpose_rhs:
        x = x.to(torch.bfloat16)
        _call("grouped_gemm_gmm_wgmma", (x, w, group_sizes, out),
              (A, x.shape[1], out.shape[1], E, 1, int(load_path(x, w) == "tma"), 1))
        return
    config = config or gmm_config(A)
    if config not in GMM_CONFIGS:
        raise ValueError(f"gmm: config must be one of {GMM_CONFIGS}, got {config!r}")
    _call("grouped_gemm_gmm_wgmma", (x, w, group_sizes, out),
          (A, x.shape[1], out.shape[1], E, int(config == "large"),
           int(load_path(x, w) == "tma"), 0))


def launch_tgmm(x, dy, group_sizes, out):
    """K5 into a given output (every element of `out` is written), then its
    reduction where a group may span several chunks; an f32 dy is rounded to
    bf16 first.  Returns the f32 [tgmm_workspace_slots(A, E), K, N]
    workspace of partials the reduction read, or None when it did not run."""
    dy = dy.to(torch.bfloat16)
    A, K = x.shape
    E, N = out.shape[0], dy.shape[1]
    slots = tgmm_workspace_slots(A, E)
    ws = torch.empty(slots, K, N, dtype=torch.float32, device=x.device) if slots else None
    _call("grouped_gemm_tgmm", (x, dy, group_sizes, out, ws),
          (A, K, N, E, TGMM_CHUNK_ROWS, int(load_path(x, dy) == "tma")))
    if ws is not None:
        launch_tgmm_reduce(ws, group_sizes, out, A)
    return ws


def launch_tgmm_reduce(workspace, group_sizes, out, rows: int) -> None:
    """K5's second kernel: dW[g] of every group of more than one chunk, the
    sum of its partials in `workspace` in chunk order."""
    E, K, N = out.shape
    _call("grouped_gemm_tgmm_reduce", (workspace, group_sizes, out),
          (rows, K, N, E, TGMM_CHUNK_ROWS))


def gmm(x, w, group_sizes, *, transpose_rhs: bool = False, config=None) -> torch.Tensor:
    """out[r] = x[r] · W[g(r)] ([A, K] · [E, K, N] → [A, N]), or with
    transpose_rhs x[r] · W[g(r)]ᵀ ([A, N] · [E, K, N] → [A, K]).  The output
    is f32 (f64 for f64 inputs, plain version only), or W's dtype with
    transpose_rhs (the input gradient's dtype in the VJP).  `config` forces
    K4's tile configuration on the card (default `gmm_config(A)`)."""
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
    config = config or gmm_config(x.shape[0])
    launch_gmm(x, w, group_sizes, out, transpose_rhs, config=config)
    if transpose_rhs:
        gmm.transposed_launches += 1
    else:
        gmm.launches += 1
        gmm.launches_by_config[config] += 1
    return out


def tgmm(x, dy, group_sizes, num_groups: int) -> torch.Tensor:
    """dW[g] = Σ_{r in g} x[r]ᵀ dy[r] ([A, K], [A, N] → [E, K, N]) in x's
    dtype; a group with no rows gets zeros.  On the card an f32 dy is
    rounded to bf16 before K5."""
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
    if launch_tgmm(x, dy, group_sizes, out) is not None:
        tgmm.reduce_launches += 1
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
        if w.dtype == torch.bfloat16:        # rounded once for K4ᵀ and K5, which take bf16
            dy = dy.to(torch.bfloat16)
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
gmm.launches_by_config = dict.fromkeys(GMM_CONFIGS, 0)
gmm.transposed_launches = 0
tgmm.launches = 0
tgmm.reduce_launches = 0
grouped_matmul.launches = 0
