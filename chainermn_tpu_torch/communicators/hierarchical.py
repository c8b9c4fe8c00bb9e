"""Hierarchical communicator — intra-node reduce, inter-node allreduce,
intra-node broadcast.

Port of ``chainermn_tpu/communicators/hierarchical.py``.  Where the
reference chains two psums over mesh axes, the port runs ChainerMN's own
three phases over the two ``new_group``s of the topology: (1) reduce to
the node leader (``intra_rank == 0``), (2) allreduce among the leaders,
(3) broadcast back within the node.  Only one rank per node crosses the
inter-node link.

``scatter_inter=True`` (the reference's option) runs the intra leg as a
reduce-scatter instead: each rank sums ``1/intra_size`` of the buffer
over the node, that shard is allreduced over the inter group (every
rank's link in play), and the node all-gathers the result, so the inter
hop moves ``1/intra_size`` of the bytes per rank.
"""

from __future__ import annotations

import torch.distributed as dist

from .base import CommunicatorBase
from .two_dimensional import scatter_allreduce_sum


class HierarchicalCommunicator(CommunicatorBase):
    name = "hierarchical"

    def __init__(self, topology, *args, scatter_inter: bool = False,
                 **kwargs):
        super().__init__(topology, *args, **kwargs)
        self.scatter_inter = bool(scatter_inter)

    def _allreduce_sum_impl(self, buf):
        topo = self.topology
        if self.scatter_inter:
            return scatter_allreduce_sum(buf, topo)
        leader = topo.inter_rank * topo.intra_size   # global rank of intra 0
        if topo.intra_size > 1:
            dist.reduce(buf, dst=leader, group=topo.intra_group)
        if topo.intra_rank == 0 and topo.inter_size > 1:
            dist.all_reduce(buf, group=topo.inter_group)
        if topo.intra_size > 1:
            dist.broadcast(buf, src=leader, group=topo.intra_group)
        return buf

    def _allreduce_impl(self, tensors):
        if self.scatter_inter:
            return [self._allreduce_sum_impl(g.reshape(-1))
                    .div_(self.size).view_as(g) for g in tensors]
        for g in tensors:
            self._allreduce_sum_impl(g).div_(self.size)
        return tensors
