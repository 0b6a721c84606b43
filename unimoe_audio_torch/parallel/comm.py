"""The collectives that the JAX package leaves to GSPMD, written out for
`torch.distributed` (NCCL on the card, gloo on the CPU), each with its
gradient:

  copy_to(x, g)      identity; the backward sums the gradient over g — the
                     entry of a tensor-parallel region (Megatron's f);
  reduce_from(x, g)  sum over g; the backward passes the gradient through
                     (Megatron's g): the exit of a row-split product, and
                     the sums of a loss whose later arithmetic every rank of
                     g repeats;
  gather_last(x, g)  the ranks' pieces concatenated along the last dim, in
                     group-rank order; the backward keeps this rank's piece;
  all_to_all(x, g)   dim 0 split into |g| blocks, block j sent to rank j and
                     the received blocks stacked in source order; the
                     backward sends the gradients back the same way.

Every one of them is the identity on a group of one rank (or None), so a
1 x 1 x 1 mesh runs no collective in the layers.  Half-precision sums run
in f32 and round once.
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


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.n, ctx.idx = n, dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=-1)[ctx.idx].contiguous(), None


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


def gather_last(x: torch.Tensor, group) -> torch.Tensor:
    return x if group_size(group) == 1 else _GatherLast.apply(x, group)


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
    n = group_size(group)
    if n == 1:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Gradient-free: x summed over the group, and this rank's 1/|group|
    slice of the sum along dim (`torch.chunk` order)."""
    n = group_size(group)
    if n == 1:
        return x
    xs = x.detach().movedim(dim, 0).contiguous()
    out = torch.empty((xs.shape[0] // n,) + tuple(xs.shape[1:]), dtype=xs.dtype,
                      device=xs.device)
    dist.reduce_scatter_tensor(out, xs, group=group)
    return out.movedim(0, dim)


def is_writer() -> bool:
    """Whether this process writes shared outputs (files): global rank 0,
    or every process when no process group runs."""
    return not dist.is_initialized() or dist.get_rank() == 0
