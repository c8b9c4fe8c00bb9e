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
            dist.all_reduce(g)
            g.div_(n)
        return tensors
