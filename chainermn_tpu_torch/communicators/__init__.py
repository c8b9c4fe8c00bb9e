"""Communicator factory — port of ``chainermn_tpu/communicators/__init__.py``.

Name map (reference → port):

=================  ==========================================================
``naive``          one allreduce per tensor (per bucket when bucketed)
``flat``           one fused allreduce over one packed buffer (alias)
``pure_nccl``      alias of ``xla_ici``
``xla_ici``        one fused NCCL allreduce per bucket
``hierarchical``   intra-node reduce → inter-node allreduce → intra bcast
                   (``scatter_inter``: intra reduce-scatter → inter
                   allreduce → intra all-gather, per tensor)
``non_cuda_aware``  alias of ``hierarchical``
``two_dimensional``  intra reduce-scatter → inter allreduce → intra all-gather
``single_host``    one allreduce within one node; raises over several nodes
``single_node``    alias of ``single_host`` (the reference's name)
=================  ==========================================================
"""

from __future__ import annotations

from .._device import resolve_device
from . import overlap, packing, quant
from .base import CommunicatorBase
from .hierarchical import HierarchicalCommunicator
from .mesh_utils import Topology, build_topology
from .naive import NaiveCommunicator
from .overlap import OverlapSchedule, build_overlap_schedule
from .packing import DEFAULT_BUCKET_BYTES, GradPacker, pack_tree
from .single_host import SingleHostCommunicator, SingleNodeCommunicator
from .two_dimensional import TwoDimensionalCommunicator
from .xla_ici import FlatCommunicator, XlaIciCommunicator

_COMMUNICATORS: dict = {
    "naive": NaiveCommunicator,
    "flat": FlatCommunicator,
    "xla_ici": XlaIciCommunicator,
    "pure_nccl": XlaIciCommunicator,
    "hierarchical": HierarchicalCommunicator,
    "non_cuda_aware": HierarchicalCommunicator,
    "two_dimensional": TwoDimensionalCommunicator,
    "single_host": SingleHostCommunicator,
    "single_node": SingleNodeCommunicator,
}


def create_communicator(
    communicator_name: str = "xla_ici",
    device="cuda",
    allreduce_grad_dtype=None,
    inter_size: int | None = None,
    intra_size: int | None = None,
    bucket_bytes: int | None = None,
    scatter_inter: bool = False,
    overlap: bool | None = None,
    overlap_granularity: int | None = None,
    comm_dtype=None,
) -> CommunicatorBase:
    """Create a communicator by name (reference signature with ``mesh``
    replaced by ``device``).

    Joins the default ``torch.distributed`` process group if this
    process has not (NCCL for a CUDA device, gloo for the CPU; see
    :func:`mesh_utils.ensure_process_group`), then builds the intra/inter
    sub-groups.  ``inter_size``/``intra_size`` force the node
    factorization; ``bucket_bytes`` caps the fused gradient buckets
    (``None`` = ``CHAINERMN_TPU_BUCKET_BYTES``, else 4 MiB; ``0`` =
    unbucketed); ``scatter_inter`` (hierarchical only) runs the intra leg
    as reduce-scatter/all-gather so the inter hop moves ``1/intra_size``
    of the bytes; ``overlap`` pins the
    backward-overlapped bucket launch (``None`` = ``CHAINERMN_TPU_OVERLAP``,
    default ON) and ``overlap_granularity`` its buckets per stage;
    ``comm_dtype`` (``"int8"``/``"fp8"``) puts the buckets on a scaled
    narrow wire (``None`` = ``CHAINERMN_TPU_COMM_DTYPE``, default off)."""
    if communicator_name not in _COMMUNICATORS:
        raise ValueError(
            f"unknown communicator {communicator_name!r}; "
            f"choose from {sorted(_COMMUNICATORS)}"
        )
    cls = _COMMUNICATORS[communicator_name]
    kwargs: dict = dict(
        allreduce_grad_dtype=allreduce_grad_dtype, bucket_bytes=bucket_bytes,
        overlap=overlap, overlap_granularity=overlap_granularity,
        comm_dtype=comm_dtype)
    if scatter_inter:
        if not issubclass(cls, HierarchicalCommunicator):
            raise ValueError(
                "scatter_inter is only meaningful for the hierarchical "
                f"communicator, not {communicator_name!r}")
        kwargs["scatter_inter"] = True
    topo = build_topology(resolve_device(device), inter_size=inter_size,
                          intra_size=intra_size)
    return cls(topo, **kwargs)


__all__ = [
    "CommunicatorBase",
    "NaiveCommunicator",
    "FlatCommunicator",
    "XlaIciCommunicator",
    "HierarchicalCommunicator",
    "TwoDimensionalCommunicator",
    "SingleHostCommunicator",
    "SingleNodeCommunicator",
    "Topology",
    "build_topology",
    "create_communicator",
    "GradPacker",
    "OverlapSchedule",
    "build_overlap_schedule",
    "pack_tree",
    "DEFAULT_BUCKET_BYTES",
    "overlap",
    "packing",
    "quant",
]
