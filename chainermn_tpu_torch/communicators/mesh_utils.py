"""Process-group topology — the port's counterpart of
``chainermn_tpu/communicators/mesh_utils.py``.

The reference runs one process over a virtual ``(inter, intra)`` device
mesh.  The port returns to ChainerMN's own model: one process per rank
over ``torch.distributed`` (NCCL between GPUs, gloo on the CPU), ranks
laid out node-major, so ``inter_rank = rank // intra_size`` and
``intra_rank = rank % intra_size`` — the reference's hostname-major rank
order.  The intra-/inter-node sub-communicators of ChainerMN's
``init_intra_mpi_comm``/``init_inter_mpi_comm`` become ``new_group``s.
"""

from __future__ import annotations

import dataclasses
import os
import socket

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Topology:
    """Rank layout of one process in the world."""

    device: torch.device
    rank: int
    size: int
    intra_rank: int
    intra_size: int
    inter_rank: int
    inter_size: int
    intra_group: object     # ranks of this node
    inter_group: object     # ranks with this intra_rank, one per node
    # A ``split`` communicator's own process group and its members' global
    # ranks in communicator-rank order; ``None`` for the whole world.
    group: object = None
    members: tuple | None = None
    # Gloo group for the object plane (pickles never ride device tensors);
    # ``None`` means the world's default group, when that is gloo.
    obj_group: object = None


def _free_localhost_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def ensure_process_group(device: torch.device) -> None:
    """Join the default process group unless it already exists.

    With ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT`` in the
    environment (a launcher's contract) the group comes from there;
    otherwise this process forms a world of one on a free localhost port.
    NCCL serves a CUDA device, gloo the CPU."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    env = os.environ
    if all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                              "MASTER_PORT")):
        dist.init_process_group(backend, init_method="env://")
        return
    dist.init_process_group(
        backend,
        init_method=f"tcp://localhost:{_free_localhost_port()}",
        rank=0, world_size=1,
    )


def build_topology(device: torch.device, inter_size: int | None = None,
                   intra_size: int | None = None) -> Topology:
    """Factor the world into ``(inter, intra)`` and create the two
    sub-groups.  Default: one node holding every rank (``inter_size=1``),
    the layout of one multi-GPU host; forcing a factorization is the
    testing analogue of ``mpiexec`` over several nodes.  A launcher's
    ``LOCAL_WORLD_SIZE`` sets the node width when neither size is given.

    Every rank must call this with the same sizes: ``new_group`` is
    collective over the whole world.  A CUDA device without an index
    becomes ``cuda:LOCAL_RANK`` (0 without a launcher), ChainerMN's
    one-GPU-per-intra-rank rule.  Over NCCL with more than one rank, a
    gloo group of the world carries the object plane."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    ensure_process_group(device)
    rank, size = dist.get_rank(), dist.get_world_size()
    if inter_size is None and intra_size is None:
        intra_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    if inter_size is None:
        inter_size = size // intra_size
    if intra_size is None:
        intra_size = size // inter_size
    if inter_size * intra_size != size:
        raise ValueError(
            f"topology ({inter_size}, {intra_size}) does not cover "
            f"{size} ranks"
        )
    intra_group = inter_group = None
    for node in range(inter_size):
        ranks = list(range(node * intra_size, (node + 1) * intra_size))
        g = dist.new_group(ranks)
        if rank in ranks:
            intra_group = g
    for local in range(intra_size):
        ranks = list(range(local, size, intra_size))
        g = dist.new_group(ranks)
        if rank in ranks:
            inter_group = g
    obj_group = None
    # (A "fake" world, torch's process group without peers, has no
    # object plane: nothing of its store reaches another process.)
    if size > 1 and dist.get_backend() not in ("gloo", "fake"):
        obj_group = dist.new_group(backend="gloo")
    return Topology(
        device=device, rank=rank, size=size,
        intra_rank=rank % intra_size, intra_size=intra_size,
        inter_rank=rank // intra_size, inter_size=inter_size,
        intra_group=intra_group, inter_group=inter_group,
        obj_group=obj_group,
    )
