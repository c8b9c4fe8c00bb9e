"""Flat single-collective communicator — ``xla_ici`` / ``pure_nccl`` / ``flat``.

Port of ``chainermn_tpu/communicators/xla_ici.py`` (reference: ChainerMN's
``pure_nccl_communicator.py`` and ``flat_communicator.py``): pack every
tensor into one contiguous buffer in a common dtype, one
``ncclAllReduce`` over it, divide by the world size, unpack.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .base import CommunicatorBase
from .packing import pack_tree


class XlaIciCommunicator(CommunicatorBase):
    name = "xla_ici"

    def _allreduce_impl(self, tensors):
        if not tensors:
            return tensors
        # Pack in the widest dtype so the single fused collective is
        # well-typed (allreduce_grad already applied allreduce_grad_dtype).
        common = tensors[0].dtype
        for t in tensors[1:]:
            common = torch.promote_types(common, t.dtype)
        if len(tensors) == 1 and tensors[0].is_contiguous():
            flat = tensors[0].to(common).view(-1)
            unpack = lambda b: [b.view(tensors[0].shape)]  # noqa: E731
        else:
            flat, unpack = pack_tree([t.to(common) for t in tensors])
        dist.all_reduce(flat, group=self.group)
        flat.div_(self.size)
        return [o.to(t.dtype) for o, t in zip(unpack(flat), tensors)]

    def _allreduce_async(self, buf):
        work = dist.all_reduce(buf, group=self.group, async_op=True)

        def done():
            work.wait()
            return buf.div_(self.size)

        return done


class FlatCommunicator(XlaIciCommunicator):
    """``flat``: the CUDA-aware-MPI spelling of the same algorithm."""

    name = "flat"
