"""The collectives of the parallel layer, with gradients.

c10d's ``send``/``recv``, ``all_to_all_single`` and ``all_reduce`` are
not autograd-aware; JAX differentiates ``ppermute``, ``all_to_all`` and
``psum``.  Each function here is an ``autograd.Function`` whose backward
is the adjoint of its forward, so that the ranks' backward passes, run
together, give the gradient of the sum of the ranks' losses:

- :func:`permute`: rank i sends to rank (i + shift) mod n of the group;
  backward permutes the gradient the other way;
- :func:`all_to_all`: chunk j of dim 0 goes to rank j (an equal split);
  the adjoint of that exchange is the same exchange;
- :func:`all_reduce_sum`: backward all-reduces the gradient;
- :func:`broadcast_replicated`: every rank gets rank ``src``'s value,
  which the ranks then hold as ONE replicated value (a ``shard_map``
  output with ``out_specs=P()``): each rank's copy carries the same
  cotangent, and backward keeps ``src``'s only;
- :func:`gather_replicated`: the group's shards concatenated along a
  dim, for a consumer that runs replicated on every rank of the group;
  backward keeps this rank's slice of the gradient.

In a group of one rank each is the identity (no send to oneself).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    """The ranks of ``group``."""
    return dist.get_world_size(group)


def _permute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = group_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -ctx.shift), None, None


def permute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``jax.lax.ppermute`` with the ring permutation i -> i + shift."""
    if group_size(group) == 1:
        return x
    return _Permute.apply(x, group, shift)


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


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Dim 0 of ``x`` in n equal chunks; chunk j goes to rank j, and
    the chunk from rank j lands at position j."""
    if x.shape[0] % group_size(group):
        raise ValueError(f"dim 0 ({x.shape[0]}) must divide by the group's "
                         f"{group_size(group)} ranks")
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


def _reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``jax.lax.psum`` over the group."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src):
        ctx.mine = dist.get_rank(group) == src
        out = x.contiguous().clone()
        dist.broadcast(out, dist.get_global_rank(group, src), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None, None


def broadcast_replicated(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank, as one replicated value
    (see the module's note on its gradient)."""
    if group_size(group) == 1:
        return x
    return _Broadcast.apply(x, group, src)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(x) for _ in range(group_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n, me = group_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[me].contiguous(), None, None


def gather_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's shards of one tensor, concatenated along ``dim`` in
    group-rank order (see the module's note on its gradient)."""
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, group, dim)
