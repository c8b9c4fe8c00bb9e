"""Communicator base class — port of ``chainermn_tpu/communicators/base.py``.

ChainerMN's model, restored: one process per rank, each holding its own
copy of the model, with an eager communicator whose methods *are* the
network operations (``torch.distributed`` collectives; NCCL on the GPU,
gloo on the CPU).  This slice carries the surface the multi-node
optimizer needs: the rank properties, ``bcast``/``broadcast_data``,
``allreduce_grad`` (a mean over bucketed flat buffers) and ``barrier``.
The object plane beyond ``bcast_obj``, ``split``, the quantized wire and
the backward-overlapped schedule are later slices (ROADMAP A2, A5).
"""

from __future__ import annotations

from typing import Mapping, Sequence

import torch
import torch.distributed as dist

from . import packing
from .mesh_utils import Topology


def _leaves(tree):
    """Tensors of a tensor, a sequence of tensors or a mapping of them, in
    order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return list(tree.values())
    return list(tree)


class CommunicatorBase:
    """Abstract communicator; subclasses specialise :meth:`_allreduce_impl`.

    ``allreduce_grad_dtype`` casts gradients before the collective and
    back after (the reference's ``pure_nccl`` fp16 option);
    ``bucket_bytes`` caps the fused gradient buckets (``None`` = 4 MiB,
    ``0`` = one collective per tensor through the subclass's own path)."""

    name = "base"

    def __init__(self, topology: Topology, allreduce_grad_dtype=None,
                 bucket_bytes: int | None = None):
        self.topology = topology
        self.allreduce_grad_dtype = allreduce_grad_dtype
        if bucket_bytes is not None and int(bucket_bytes) < 0:
            raise ValueError(f"bucket_bytes must be >= 0, got {bucket_bytes}")
        self.bucket_bytes = (
            packing.DEFAULT_BUCKET_BYTES if bucket_bytes is None
            else int(bucket_bytes)
        )
        self._packers: dict = {}      # bucket plan per (shapes, dtypes)

    # -- topology (reference ``rank``/``size``/``intra_*``/``inter_*``) --
    @property
    def device(self) -> torch.device:
        return self.topology.device

    @property
    def rank(self) -> int:
        return self.topology.rank

    @property
    def size(self) -> int:
        return self.topology.size

    @property
    def intra_rank(self) -> int:
        return self.topology.intra_rank

    @property
    def intra_size(self) -> int:
        return self.topology.intra_size

    @property
    def inter_rank(self) -> int:
        return self.topology.inter_rank

    @property
    def inter_size(self) -> int:
        return self.topology.inter_size

    # -- model plane ----------------------------------------------------
    def bcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Broadcast ``x`` from rank ``root``, in place; returns ``x``."""
        if self.size > 1:
            dist.broadcast(x, src=root)
        return x

    def broadcast_data(self, tensors, root: int = 0):
        """Replicate parameters from ``root`` to every rank, in place
        (reference ``broadcast_data(model)``, the multi-node optimizer's
        first-update broadcast).  Takes a module, a sequence or a mapping
        of tensors."""
        if isinstance(tensors, torch.nn.Module):
            tensors = list(tensors.parameters())
        with torch.no_grad():
            for t in _leaves(tensors):
                self.bcast(t, root)
        return tensors

    def bcast_obj(self, obj, root: int = 0):
        """Broadcast a picklable object from ``root`` (the one object-plane
        call :func:`scatter_dataset` needs)."""
        if self.size <= 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=root)
        return box[0]

    def allreduce_grad(self, grads):
        """Average gradients across the world, in place.

        ``grads`` is a sequence or mapping of tensors (the port updates
        them in place rather than returning a new tree, which saves a
        full gradient copy); it is also returned.  Reference contract
        (``base.py:548-592``): the optional ``allreduce_grad_dtype`` cast
        and cast back, and for more than one tensor the bucketed packing
        — one collective per per-dtype bucket instead of one per tensor.
        ``bucket_bytes=0`` gives each subclass's unbucketed path.  On one
        rank the mean is the input: only the dtype round trip is applied,
        with no packing and no collective."""
        leaves = _leaves(grads)
        if not leaves:
            return grads
        if self.size == 1:
            if self.allreduce_grad_dtype is not None:
                with torch.no_grad():
                    for g in leaves:
                        g.copy_(g.to(self.allreduce_grad_dtype))
            return grads
        work = leaves
        if self.allreduce_grad_dtype is not None:
            work = [g.to(self.allreduce_grad_dtype) for g in leaves]
        if len(work) > 1 and self.bucket_bytes > 0:
            key = tuple((tuple(g.shape), g.dtype) for g in work)
            packer = self._packers.get(key)
            if packer is None:
                packer = packing.GradPacker.for_tensors(work,
                                                        self.bucket_bytes)
                self._packers[key] = packer
            bufs = packer.pack(work)
            bufs = [self._allreduce_impl([b])[0] for b in bufs]
            out = packer.unpack(bufs)
        else:
            out = self._allreduce_impl(work)
        with torch.no_grad():
            for g, r in zip(leaves, out):
                g.copy_(r)
        return grads

    def _allreduce_impl(self, tensors: Sequence[torch.Tensor]):
        """Mean of each tensor over the world; returns the results (which
        may be the inputs, reduced in place)."""
        raise NotImplementedError

    def barrier(self):
        if self.size > 1:
            dist.barrier()

    def __repr__(self):
        return (
            f"{type(self).__name__}(rank={self.rank}, size={self.size}, "
            f"inter={self.inter_size}, intra={self.intra_size}, "
            f"device={self.device})"
        )
