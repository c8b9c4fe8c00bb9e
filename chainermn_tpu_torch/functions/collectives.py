"""Differentiable collectives — port of
``chainermn_tpu/functions/collectives.py`` (ChainerMN's
``collective_communication.py``).

Each is an autograd function over the communicator's tensor collective
whose backward is the transpose collective.  The gradient is that of the
total objective, the sum over the ranks of each rank's loss, which is
what the reference computes when it differentiates its SPMD program:

=============  =======================================================
``allgather``  reduce-scatter of the gradients
``alltoall``   all-to-all with the split and concat axes swapped
``bcast``      sum of the gradients on the root, zeros elsewhere
``gather``     the root's gradient scattered back to each source
``scatter``    the chunks' gradients gathered to the root
``allreduce``  sum of the gradients (every rank's input feeds every
               rank's output; the reference's docstring says
               "broadcasts", its gradient is this sum)
=============  =======================================================

Every rank calls each function and must take its result into its own
backward, since the backward is collective too.
"""

from __future__ import annotations

import torch


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, axis, tiled, x):
        ctx.comm, ctx.axis, ctx.tiled = comm, axis, tiled
        return comm.allgather(x, axis=axis, tiled=tiled)

    @staticmethod
    def backward(ctx, g):
        gx = ctx.comm.reduce_scatter(g.contiguous(), ctx.axis)
        return None, None, None, gx if ctx.tiled else gx.squeeze(ctx.axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, split_axis, concat_axis, x):
        ctx.comm, ctx.axes = comm, (split_axis, concat_axis)
        return comm.alltoall(x, split_axis=split_axis,
                             concat_axis=concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return None, None, None, ctx.comm.alltoall(
            g, split_axis=concat_axis, concat_axis=split_axis)


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, root, x):
        ctx.comm, ctx.root = comm, root
        return comm.bcast(x.clone(), root)

    @staticmethod
    def backward(ctx, g):
        total = ctx.comm.allreduce(g, "sum")
        if ctx.comm.rank != ctx.root:
            total = torch.zeros_like(total)
        return None, None, total


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, root, axis, x):
        ctx.comm, ctx.root, ctx.axis = comm, root, axis
        return comm.gather(x, root=root, axis=axis)

    @staticmethod
    def backward(ctx, g):
        chunk = ctx.comm.scatter(g.movedim(ctx.axis, 0).contiguous(),
                                 root=ctx.root)
        return None, None, None, chunk[0]


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, root, x):
        ctx.comm, ctx.root, ctx.shape = comm, root, x.shape
        return comm.scatter(x, root=root)

    @staticmethod
    def backward(ctx, g):
        stacked = ctx.comm.gather(g.contiguous(), root=ctx.root, axis=0)
        return None, None, stacked.reshape(ctx.shape)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm.allreduce(x, "sum")

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm.allreduce(g, "sum")


def allgather(communicator, x, axis: int = 0, tiled: bool = False):
    """Every rank's ``x``, stacked on a new ``axis`` (concatenated along it
    with ``tiled``).  Backward: reduce-scatter."""
    return _AllGather.apply(communicator, axis, tiled, x)


def alltoall(communicator, x, split_axis: int = 0, concat_axis: int = 0):
    """Chunk ``j`` along ``split_axis`` to rank ``j``, received chunks
    concatenated along ``concat_axis``.  Backward: the reverse
    all-to-all."""
    return _AllToAll.apply(communicator, split_axis, concat_axis, x)


def bcast(communicator, x, root: int = 0):
    """``root``'s ``x`` on every rank.  Backward: the sum of the gradients
    to the root."""
    return _Bcast.apply(communicator, root, x)


def gather(communicator, x, root: int = 0, axis: int = 0):
    """``root`` gets every rank's ``x`` stacked on ``axis``, the others
    zeros.  Backward: the root's gradient scattered to the sources."""
    return _Gather.apply(communicator, root, axis, x)


def scatter(communicator, x, root: int = 0):
    """Rank ``d`` gets chunk ``d`` of ``root``'s ``x`` along axis 0.
    Backward: the chunks' gradients gathered to the root."""
    return _Scatter.apply(communicator, root, x)


def allreduce(communicator, x):
    """Sum of ``x`` over the ranks.  Backward: the sum of the
    gradients."""
    return _AllReduce.apply(communicator, x)
