"""Communicator factory — port of ``chainermn_tpu/communicators/__init__.py``.

Name map (reference → port):

=================  ==========================================================
``naive``          one allreduce per tensor (per bucket when bucketed)
``flat``           one fused allreduce over one packed buffer (alias)
``pure_nccl``      alias of ``xla_ici``
``xla_ici``        one fused NCCL allreduce per bucket
``hierarchical``   intra-node reduce → inter-node allreduce → intra bcast
``non_cuda_aware``  alias of ``hierarchical``
``two_dimensional``  not ported yet (ROADMAP A2)
``single_host``    not ported yet (ROADMAP A2; reference ``single_node``)
=================  ==========================================================
"""

from __future__ import annotations

from .._device import resolve_device
from .base import CommunicatorBase
from .hierarchical import HierarchicalCommunicator
from .mesh_utils import Topology, build_topology
from .naive import NaiveCommunicator
from .packing import DEFAULT_BUCKET_BYTES, GradPacker, pack_tree
from .xla_ici import FlatCommunicator, XlaIciCommunicator

_COMMUNICATORS: dict = {
    "naive": NaiveCommunicator,
    "flat": FlatCommunicator,
    "xla_ici": XlaIciCommunicator,
    "pure_nccl": XlaIciCommunicator,
    "hierarchical": HierarchicalCommunicator,
    "non_cuda_aware": HierarchicalCommunicator,
    # Known names whose port is a later slice.
    "two_dimensional": None,
    "single_host": None,
    "single_node": None,
}


def create_communicator(
    communicator_name: str = "xla_ici",
    device="cuda",
    allreduce_grad_dtype=None,
    inter_size: int | None = None,
    intra_size: int | None = None,
    bucket_bytes: int | None = None,
) -> CommunicatorBase:
    """Create a communicator by name (reference signature with ``mesh``
    replaced by ``device``).

    Joins the default ``torch.distributed`` process group if this
    process has not (NCCL for a CUDA device, gloo for the CPU; see
    :func:`mesh_utils.ensure_process_group`), then builds the intra/inter
    sub-groups.  ``inter_size``/``intra_size`` force the node
    factorization; ``bucket_bytes`` caps the fused gradient buckets
    (``None`` = 4 MiB, ``0`` = unbucketed)."""
    if communicator_name not in _COMMUNICATORS:
        raise ValueError(
            f"unknown communicator {communicator_name!r}; "
            f"choose from {sorted(_COMMUNICATORS)}"
        )
    cls = _COMMUNICATORS[communicator_name]
    if cls is None:
        raise NotImplementedError(
            f"communicator {communicator_name!r} is not ported yet "
            "(ROADMAP A2)"
        )
    topo = build_topology(resolve_device(device), inter_size=inter_size,
                          intra_size=intra_size)
    return cls(topo, allreduce_grad_dtype=allreduce_grad_dtype,
               bucket_bytes=bucket_bytes)


__all__ = [
    "CommunicatorBase",
    "NaiveCommunicator",
    "FlatCommunicator",
    "XlaIciCommunicator",
    "HierarchicalCommunicator",
    "Topology",
    "build_topology",
    "create_communicator",
    "GradPacker",
    "pack_tree",
    "DEFAULT_BUCKET_BYTES",
]
