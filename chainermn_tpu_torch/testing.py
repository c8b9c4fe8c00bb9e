"""Test doubles — the port of ``chainermn_tpu/testing.py`` (ChainerMN's
``chainermn/testing`` stub communicator).

``DummyCommunicator`` pins the host-plane topology (``rank``/``size``)
and runs the object plane locally, so wrapper logic (dataset chunking
arithmetic, evaluator dict averaging, iterator lockstep) is unit-testable
without a process group.  Device-plane collectives raise: anything that
moves tensors belongs in a test over real (gloo) ranks.
"""

from __future__ import annotations

from typing import Any, List, Optional

_DEVICE_PLANE = (
    "allreduce", "bcast", "allgather", "alltoall", "reduce_scatter",
    "scatter", "ppermute", "allreduce_grad", "broadcast_data",
    "shard_map", "axis_index",
)


class DummyCommunicator:
    def __init__(self, rank: int = 0, size: int = 1,
                 peers: Optional[List["DummyCommunicator"]] = None):
        self.rank = rank
        self.size = size
        self._peers = peers  # optional shared mailbox group
        self._mailbox: dict[str, Any] = {}

    # ---- host/object plane (local semantics) --------------------------
    def bcast_obj(self, obj, root: int = 0):
        if self._peers is not None:
            group = self._peers
            if self.rank == root:
                for p in group:
                    p._mailbox["bcast"] = obj
            return group[root]._mailbox.get("bcast", obj)
        return obj

    def gather_obj(self, obj, root: "int | None" = None,
                   timeout_ms: "int | None" = None):
        # The real contract exactly: root=None gives the full list on
        # every rank; root=r the list at r and None elsewhere.  timeout_ms
        # is accepted (and, as in the real contract, refused without a
        # root) but nothing here blocks.
        if timeout_ms is not None and root is None:
            raise ValueError(
                "gather_obj: timeout_ms is only supported with root=..."
            )
        full = [obj] * self.size if self.size > 1 else [obj]
        if root is None:
            return full
        return full if self.rank == root else None

    def allgather_obj(self, obj):
        return self.gather_obj(obj)

    def allreduce_obj(self, obj, op=None):
        result = obj
        for _ in range(self.size - 1):
            result = op(result, obj) if op is not None else result + obj
        return result

    def scatter_obj(self, objs, root: int = 0):
        return objs[self.rank]

    def barrier(self):
        pass

    # ---- device plane: explicitly unsupported -------------------------
    def __getattr__(self, name):
        if name in _DEVICE_PLANE:
            raise NotImplementedError(
                f"DummyCommunicator has no device plane ({name}); use a real "
                "communicator over gloo ranks for transport tests"
            )
        raise AttributeError(name)


def dummy_communicators(size: int) -> List[DummyCommunicator]:
    """A group of dummies sharing a bcast mailbox (one per simulated rank)."""
    group: List[DummyCommunicator] = []
    for r in range(size):
        group.append(DummyCommunicator(rank=r, size=size, peers=group))
    return group
