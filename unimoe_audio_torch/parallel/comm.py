"""The collectives that the JAX package leaves to GSPMD, written out for
`torch.distributed` (NCCL on the card, gloo on the CPU), each with its
gradient:

  copy_to(x, g)      identity; the backward sums the gradient over g — the
                     entry of a tensor-parallel region (Megatron's f);
  reduce_from(x, g)  sum over g; the backward passes the gradient through
                     (Megatron's g): the exit of a row-split product, and
                     the sums of a loss whose later arithmetic every rank of
                     g repeats;
  gather_dim(x, g, d) the ranks' pieces concatenated along dim d, in
                     group-rank order; the backward keeps this rank's piece
                     (right where every rank's gradient of the whole is the
                     whole gradient: the consumers are repeated on every
                     rank, or enter through copy_to);
  scatter_dim(x, g, d) this rank's piece along d of a tensor every rank
                     holds whole; the backward all-gathers the pieces'
                     gradients;
  reduce_scatter(x, g, d) x summed over g, and this rank's piece of the sum
                     along d; the backward all-gathers (Megatron sequence
                     parallelism: the exit of a row-split product);
  ppermute(x, g, s)  group rank i sends x to rank i + s (mod |g|) and
                     receives rank i - s's (`lax.ppermute` with the
                     permutation [(i, i + s)]); every rank posts its send
                     and its receive together (`batch_isend_irecv`); the
                     backward shifts the gradient by -s;
  all_to_all(x, g)   dim 0 split into |g| blocks, block j sent to rank j and
                     the received blocks stacked in source order; the
                     backward sends the gradients back the same way.

Every one of them is the identity on a group of one rank (or None), so a
1 x 1 x 1 mesh runs no collective in the layers.  Half-precision sums run
in f32 and round once.  A group may also be given as (mesh, axis), the
counterpart of a JAX axis name inside `shard_map` (`resolve_group`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over group, a new tensor (f32 arithmetic for half types)."""
    y = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.contiguous(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _piece(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim=dim)[dist.get_rank(group)].contiguous()


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """x summed over group, this rank's piece along dim (f32 arithmetic for
    half types)."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {n} ranks")
    y = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    y = y.movedim(dim, 0).contiguous()
    out = torch.empty((y.shape[0] // n,) + tuple(y.shape[1:]), dtype=y.dtype, device=y.device)
    dist.reduce_scatter_tensor(out, y, group=group)
    return out.movedim(0, dim).to(x.dtype)


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n, i = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (i + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (i - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _piece(g, ctx.group, ctx.dim), None, None


class _ScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _piece(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -ctx.shift), None, None


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceFrom.apply(x, group)


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherDim.apply(x, group, dim)


def scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group_size(group) == 1 else _ScatterDim.apply(x, group, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group_size(group) == 1 else _ReduceScatter.apply(x, group, dim)


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """x sent to group rank i + shift and the tensor of rank i - shift
    received (both mod |group|)."""
    return x if group_size(group) == 1 else _PPermute.apply(x, group, shift)


def resolve_group(group):
    """A process group (or None) from a group or a (mesh, axis) pair."""
    if isinstance(group, tuple):
        mesh, axis = group
        return mesh.group(axis)
    return group


def group_rank(group) -> int:
    return 0 if group_size(group) == 1 else dist.get_rank(group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...] with n = |group|: block j goes to group rank j; returns
    the blocks received, [n, ...] by source rank."""
    return x if group_size(group) == 1 else _AllToAll.apply(x, group)


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Gradient-free all-reduce into a new tensor (x unchanged)."""
    if group_size(group) == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Gradient-free: the ranks' pieces concatenated along dim, in group-rank
    order."""
    return x if group_size(group) == 1 else _all_gather(x.detach(), group, dim)


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Gradient-free: x summed over the group, and this rank's 1/|group|
    slice of the sum along dim (`torch.chunk` order)."""
    return x if group_size(group) == 1 else _reduce_scatter(x.detach(), group, dim)


def is_writer() -> bool:
    """Whether this process writes shared outputs (files): global rank 0,
    or every process when no process group runs."""
    return not dist.is_initialized() or dist.get_rank() == 0
