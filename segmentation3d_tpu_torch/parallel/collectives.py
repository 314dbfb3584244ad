"""Collectives that autograd differentiates, for training over several ranks.

The JAX package's sharded step leaves these to GSPMD: the ``psum`` of a
loss's sums over the z shards, the halo exchange of a 3^3 conv along z,
and BatchNorm's reductions (``models/vnet.py:BatchNorm``). Here each is a
``torch.autograd.Function`` whose backward is the forward's adjoint, so
that every rank's gradients sum to the gradient of the sum of all ranks'
losses; DDP's average over the ranks then gives the global batch's mean
gradient (see ``core/seg_train.py``).

Every collective is an ``all_reduce``: on the gloo backend CUDA tensors
support only ``broadcast`` and ``all_reduce``, so the halo exchange too is
one sum over a zeroed buffer with a slot per rank. The same code runs on
NCCL. A group of one rank is never given a collective.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _sum(t, group):
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _sum(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g.clone(), ctx.group), None


def group_sum(t, group):
    """``t`` summed over the ranks of ``group``; its gradient is the sum of
    every rank's gradient of the result (the adjoint of a sum that every
    rank reads)."""
    return _GroupSum.apply(t, group)


def _neighbour_planes(lo, hi, group, rank, size, dim):
    """One all-reduce of a zeroed ``[size, 2, ...]`` buffer into which this
    rank wrote ``lo`` at ``[rank - 1, 1]`` and ``hi`` at ``[rank + 1, 0]``
    (each when that neighbour exists); returns what the neighbours wrote
    into this rank's slot, ``(from below, from above)``: zeros at the
    crop's ends."""
    # float32 at least (a sum of one value and zeros is exact in it): not
    # every backend reduces bfloat16
    buf = torch.zeros((size, 2) + tuple(lo.shape), device=lo.device,
                      dtype=torch.promote_types(lo.dtype, torch.float32))
    if rank > 0:
        buf[rank - 1, 1] = lo
    if rank + 1 < size:
        buf[rank + 1, 0] = hi
    _sum(buf, group)
    out = buf[rank].to(lo.dtype)
    return out[0].unsqueeze(dim), out[1].unsqueeze(dim)


class _HaloZ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.rank, ctx.size = group, dim, rank, size
        first, last = x.select(dim, 0), x.select(dim, x.shape[dim] - 1)
        # my first plane is rank - 1's upper halo, my last rank + 1's lower
        below, above = _neighbour_planes(first, last, group, rank, size, dim)
        return torch.cat([below, x, above], dim)

    @staticmethod
    def backward(ctx, g):
        dim, n = ctx.dim, g.shape[ctx.dim]
        # the halo planes' gradients belong to the neighbours' boundary
        # planes: the lower halo's to rank - 1's last, the upper's to rank + 1's first
        g_lo, g_hi = g.select(dim, 0), g.select(dim, n - 1)
        to_first, to_last = _neighbour_planes(g_lo, g_hi, ctx.group, ctx.rank,
                                              ctx.size, dim)
        gx = g.narrow(dim, 1, n - 2).clone()
        gx.narrow(dim, 0, 1).add_(to_first)
        gx.narrow(dim, n - 3, 1).add_(to_last)
        return gx, None, None


def halo_exchange_z(x, group, dim: int = 2):
    """``x`` (this rank's z slab, z along ``dim``) with one plane of each z
    neighbour in ``group`` around it: rank ``s - 1``'s last plane before,
    rank ``s + 1``'s first after, zeros beyond the crop's ends (a SAME
    conv's padding). Its backward adds the halo planes' gradients to the
    neighbours' boundary planes."""
    return _HaloZ.apply(x, group, dim)


def world_mean(t):
    """``t`` averaged over every rank (no gradient); ``t`` itself in one
    process."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return t
    t = _sum(t.detach().clone(), None)
    return t / dist.get_world_size()
