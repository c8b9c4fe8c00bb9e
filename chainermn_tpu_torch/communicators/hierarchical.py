"""Hierarchical communicator — intra-node reduce, inter-node allreduce,
intra-node broadcast.

Port of ``chainermn_tpu/communicators/hierarchical.py``.  Where the
reference chains two psums over mesh axes, the port runs ChainerMN's own
three phases over the two ``new_group``s of the topology: (1) reduce to
the node leader (``intra_rank == 0``), (2) allreduce among the leaders,
(3) broadcast back within the node.  Only one rank per node crosses the
inter-node link.
"""

from __future__ import annotations

import torch.distributed as dist

from .base import CommunicatorBase


class HierarchicalCommunicator(CommunicatorBase):
    name = "hierarchical"

    def _allreduce_sum_impl(self, buf):
        topo = self.topology
        leader = topo.inter_rank * topo.intra_size   # global rank of intra 0
        if topo.intra_size > 1:
            dist.reduce(buf, dst=leader, group=topo.intra_group)
        if topo.intra_rank == 0 and topo.inter_size > 1:
            dist.all_reduce(buf, group=topo.inter_group)
        if topo.intra_size > 1:
            dist.broadcast(buf, src=leader, group=topo.intra_group)
        return buf

    def _allreduce_impl(self, tensors):
        for g in tensors:
            self._allreduce_sum_impl(g).div_(self.size)
        return tensors
