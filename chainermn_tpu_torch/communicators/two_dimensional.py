"""Two-dimensional communicator — intra-node reduce-scatter, inter-node
allreduce on the shard, intra-node all-gather.

Port of ``chainermn_tpu/communicators/two_dimensional.py`` (reference:
ChainerMN's ``two_dimensional_communicator.py``): the tensors are packed
into one flat buffer in their common dtype, padded to a multiple of
``intra_size``, reduce-scattered over the node so each rank owns
1/``intra_size`` of it, summed across nodes on that shard (every rank's
link in play, unlike ``hierarchical``), and all-gathered back over the
node.  The inter-node leg moves 1/``intra_size`` of the bytes per rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .base import CommunicatorBase
from .packing import pack_tree


def scatter_allreduce_sum(buf, topo):
    """Sum of a 1-D buffer over the world by the three legs (zero padding
    is exact in any dtype, so this serves the narrow wire)."""
    k, n = topo.intra_size, buf.numel()
    pad = (-n) % k
    if pad:
        buf = torch.cat([buf, buf.new_zeros(pad)])
    shard = buf
    if k > 1:
        shard = buf.new_empty(buf.numel() // k)
        dist.reduce_scatter_tensor(shard, buf, group=topo.intra_group)
    if topo.inter_size > 1:
        dist.all_reduce(shard, group=topo.inter_group)
    if k > 1:
        full = torch.empty_like(buf)
        dist.all_gather_into_tensor(full, shard, group=topo.intra_group)
        shard = full
    return shard[:n]


class TwoDimensionalCommunicator(CommunicatorBase):
    name = "two_dimensional"

    def _allreduce_sum_impl(self, buf):
        return scatter_allreduce_sum(buf, self.topology)

    def _allreduce_impl(self, tensors):
        if not tensors:
            return tensors
        common = tensors[0].dtype
        for t in tensors[1:]:
            common = torch.promote_types(common, t.dtype)
        flat, unpack = pack_tree([t.to(common) for t in tensors])
        full = self._allreduce_sum_impl(flat) / self.size
        return [o.to(t.dtype) for o, t in zip(unpack(full), tensors)]
