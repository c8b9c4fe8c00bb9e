"""Naive communicator — the correctness oracle.

Port of ``chainermn_tpu/communicators/naive.py`` (reference: ChainerMN's
``naive_communicator.py``): one sum-allreduce per tensor, then the mean.
"""

from __future__ import annotations

import torch.distributed as dist

from .base import CommunicatorBase


class NaiveCommunicator(CommunicatorBase):
    name = "naive"

    def _allreduce_impl(self, tensors):
        n = self.size
        for g in tensors:
            dist.all_reduce(g, group=self.group)
            g.div_(n)
        return tensors

    def _allreduce_async(self, buf):
        work = dist.all_reduce(buf, group=self.group, async_op=True)

        def done():
            work.wait()
            return buf.div_(self.size)

        return done
