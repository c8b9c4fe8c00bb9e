"""Collective-order debug mode — the port of ``chainermn_tpu/utils/debug.py``.

The SPMD contract every rank trusts is that all of them issue the same
collectives, in the same order, with the same shapes and dtypes; a breach
shows up as a hang or as garbage.  This debug mode makes the contract
checkable:

* :class:`CollectiveTrace` wraps a communicator; every collective call
  appends ``(op, shapes, dtypes)`` to an order log, and every object-plane
  call ``(op, plane, endpoint ints, payload type)`` — the payload's type,
  not its content;
* :meth:`CollectiveTrace.fingerprint` hashes the symmetric part of the
  log (native crc32c); dtypes enter it under numpy's names (``float32``,
  not ``torch.float32``), so the same op sequence gives the reference's
  fingerprint;
* :meth:`CollectiveTrace.verify_across_hosts` allgathers the fingerprint
  over the object plane and raises on divergence, naming the first
  differing entry.
"""

from __future__ import annotations

import json
from typing import Any, List

from . import native

_WRAPPED = (
    "allreduce", "bcast", "allgather", "gather", "alltoall",
    "reduce_scatter", "scatter", "ppermute", "allreduce_grad",
    "broadcast_data",
)

# Object-plane ops: recorded by endpoint metadata and payload TYPE (not
# content: payloads may be large and differ between ranks by design).
_WRAPPED_OBJ = (
    "send_obj", "recv_obj", "bcast_obj", "gather_obj", "allgather_obj",
    "allreduce_obj", "scatter_obj", "barrier",
)


def _dtype_name(leaf) -> str:
    dt = getattr(leaf, "dtype", None)
    if dt is None:
        return type(leaf).__name__
    return str(dt).replace("torch.", "")


class CollectiveTrace:
    """Wrap ``comm`` so every collective appends to an order log.

    Use as ``dbg = CollectiveTrace(comm)`` and pass ``dbg`` wherever the
    communicator goes; it proxies everything else through.
    """

    def __init__(self, comm):
        self._comm = comm
        self.log: List[str] = []
        # The cross-rank check covers only SYMMETRIC ops: send_obj and
        # recv_obj differ between the two ends by design, so they appear
        # in `log` for the diagnostic trail but not in the verified one.
        self._sym: List[str] = []

    def _record(self, op: str, x: Any, **meta):
        desc = [{"shape": list(getattr(leaf, "shape", ())),
                 "dtype": _dtype_name(leaf)}
                for leaf in native._leaves(x)]
        entry = json.dumps({"op": op, "args": desc, **meta}, sort_keys=True)
        self.log.append(entry)
        self._sym.append(entry)

    def _record_obj(self, op: str, args, kwargs):
        meta = {
            "plane": self._comm.plane_name,
            "args": [a if isinstance(a, (int, str)) else type(a).__name__
                     for a in args],
            "kwargs": {k: v if isinstance(v, (int, str)) else type(v).__name__
                       for k, v in kwargs.items()},
        }
        entry = json.dumps({"op": op, **meta}, sort_keys=True)
        self.log.append(entry)
        if op not in ("send_obj", "recv_obj"):
            self._sym.append(entry)

    def __getattr__(self, name):
        attr = getattr(self._comm, name)
        if name in _WRAPPED and callable(attr):
            def traced(x, *args, **kwargs):
                self._record(name, x)
                return attr(x, *args, **kwargs)

            return traced
        if name in _WRAPPED_OBJ and callable(attr):
            def traced_obj(*args, **kwargs):
                self._record_obj(name, args, kwargs)
                return attr(*args, **kwargs)

            return traced_obj
        return attr

    # -- verification ---------------------------------------------------
    def fingerprint(self) -> int:
        return native.crc32c("\n".join(self._sym).encode())

    def verify_across_hosts(self) -> int:
        """Raise ``RuntimeError`` if any rank recorded a different
        (symmetric) collective/object-plane order; returns the common
        fingerprint otherwise."""
        fp = self.fingerprint()
        fps = self._comm.gather_obj(fp)
        if len(set(fps)) > 1:
            # Only the diagnosis needs the bulky logs: with a transport
            # store installed the ranks ship them to rank 0 alone;
            # without one every rank gathers them.
            from ..communicators import kvtransport

            if kvtransport.available():
                logs = self._comm.gather_obj(self._sym, root=0)
            else:
                logs = self._comm.gather_obj(self._sym)
            if logs is None:
                raise RuntimeError(
                    f"collective order mismatch across hosts: fingerprints "
                    f"{fps}; rank 0 holds the first differing call"
                )
            first_diff = None
            for i in range(max(len(lg) for lg in logs)):
                entries = {r: (lg[i] if i < len(lg) else "<missing>")
                           for r, lg in enumerate(logs)}
                if len(set(entries.values())) > 1:
                    first_diff = (i, entries)
                    break
            raise RuntimeError(
                f"collective order mismatch across hosts: fingerprints {fps}; "
                f"first differing call #{first_diff[0]}: {first_diff[1]}"
            )
        return fp

    def reset(self):
        self.log.clear()
        self._sym.clear()
