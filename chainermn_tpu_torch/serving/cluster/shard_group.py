"""Shard groups: one serving replica spread over several processes —
port of ``chainermn_tpu/serving/cluster/shard_group.py``.

A **shard group** is the multi-process form of a replica: one *leader*
process plus ``K-1`` *follower* shards.  The leader owns everything
stateful and cluster-facing — the scheduler, the sampling RNG, the
block tables, and all router-plane traffic (CMD/EVT/SNAP, heartbeats,
gossip).  Followers own only device state: each builds the SAME engine
(identical seed-derived parameters) and runs
a lockstep replay loop, applying every device-mutating step the leader
emits (prefill / decode / chunk / CoW / defrag) in order over its own
cache via :meth:`InferenceEngine.apply_step`.

The group's processes share no process group and no device plane (the
fleet calls no ``init_process_group``), as in the reference's CPU form:
each process holds a full mirror of the module and its pages, and the
lockstep replay keeps the mirrors bit-identical — same host arrays, same
kernels on the same shapes, same order.  The intra-group channel carries
only small host arrays (tokens, tables, lengths, as numpy), never pages.
Tensor-parallel placement across the group's cards (the engine's
``plan=``/``mesh=``) is the in-process tier's; a group prices the
lockstep replay.

Group identity and failure semantics:

* **group id = leader rank.**  The router, heartbeat monitor,
  autoscaler, KV migration, and both gossips address the leader; a
  ``K=1`` fleet degenerates to today's one-process replicas with
  unchanged ids.
* **Any-shard death fails the whole group.**  Followers send liveness
  beats on the group channel; a follower SIGKILL breaks its socket to
  the leader, so the leader's next poll (or fan-out send) raises
  :class:`PeerGone` and the leader exits its serve loop.  The leader's
  own edges then close, the router sees ``PeerGone`` on the group's
  EVT edge within one beat, and the EXISTING failover path re-places
  the group's streams on a survivor group with their committed prefix
  — bit-exact resume, nothing group-specific downstream.  A leader
  death is symmetric: followers see ``PeerGone`` on the leader edge
  and exit.

tp×pp composition: ``group_size`` is the tensor-parallel width per
pipeline stage and ``pp_stages`` the stage count — the group spans
``group_size × pp_stages`` processes.  With ``pp_stages > 1`` the
leader's engine splits every decode iteration into per-stage
microbatches.  Microbatching is bit-exact by construction: attention is
per-sequence and sampling counter-based, so a stream's tokens never
depend on batch composition.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import List, Optional, Tuple

from ...communicators.kvtransport import ObjectPlane, PeerGone

#: intra-group channel tag on the "serve" plane (CMD=1 / EVT=2 / SNAP=7
#: are the cluster-plane tags; the group channel rides the same
#: sockets, so follower death detection reuses the plane's PeerGone
#: machinery unchanged).
GRP = 3

#: recv poll slice (ms) for the group channel's non-blocking drains.
GRP_POLL_MS = 2

#: follower → leader liveness beat cadence (s).  The beats keep an
#: inbound connection open on the leader, so a follower SIGKILL is
#: observable as PeerGone on the leader's next poll.
GROUP_BEAT_S = 0.05


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """One shard group's topology.  ``leader`` is the group id; the
    group spans ``(leader,) + followers`` — ``group_size`` TP shards
    per pipeline stage × ``pp_stages`` stages."""

    leader: int
    followers: Tuple[int, ...] = ()
    group_size: int = 1
    pp_stages: int = 1

    @property
    def ranks(self) -> Tuple[int, ...]:
        return (self.leader,) + tuple(self.followers)

    @property
    def n_shards(self) -> int:
        return 1 + len(self.followers)


def plan_groups(size: int, group_size: int = 1,
                pp_stages: int = 1) -> List[GroupSpec]:
    """Partition the replica ranks ``1..size-1`` of a ``size``-process
    cluster into consecutive shard groups of ``group_size × pp_stages``
    processes each.  The first rank of each run leads (group id =
    leader rank); ranks must divide evenly — a partial group cannot
    serve.  ``group_size = pp_stages = 1`` reproduces the historical
    one-process-per-replica fleet exactly."""
    group_size = int(group_size)
    pp_stages = int(pp_stages)
    if group_size < 1 or pp_stages < 1:
        raise ValueError(
            f"group_size and pp_stages must be >= 1, got "
            f"{group_size}x{pp_stages}"
        )
    k = group_size * pp_stages
    n = size - 1
    if n < k or n % k:
        raise ValueError(
            f"{n} replica processes do not divide into shard groups of "
            f"{group_size}x{pp_stages}={k}"
        )
    return [
        GroupSpec(
            leader=start,
            followers=tuple(range(start + 1, start + k)),
            group_size=group_size,
            pp_stages=pp_stages,
        )
        for start in range(1, size, k)
    ]


class GroupLeader:
    """Leader-side half of the intra-group channel: fans mirrored
    device steps out to every follower and polls their liveness beats.
    Both paths raise :class:`PeerGone` the moment any follower edge is
    dead — the caller's serve loop treats that as group death."""

    def __init__(self, plane: ObjectPlane, spec: GroupSpec):
        self.plane = plane
        self.spec = spec
        self._subs = [plane.members.index(f) for f in spec.followers]

    def attach(self, engine) -> None:
        """Wire ``engine``'s mirror hook to this group: every device-
        mutating step the leader runs is emitted to the followers
        FIRST, so their replay overlaps the leader's own compute."""
        engine.mirror_sink = self.emit
        engine.pp_stages = self.spec.pp_stages

    def emit(self, op: str, payload) -> None:
        for sub in self._subs:
            self.plane.send(("step", op, payload), sub, tag=GRP)

    def poll(self) -> None:
        """Drain pending follower beats (bounded poll).  Raises
        PeerGone when a follower died since the last poll."""
        for sub in self._subs:
            while True:
                try:
                    self.plane.recv(sub, tag=GRP, timeout_ms=GRP_POLL_MS)
                except TimeoutError:
                    break

    def stop(self) -> None:
        """Best-effort clean shutdown of the follower loops."""
        for sub in self._subs:
            try:
                self.plane.send(("stop",), sub, tag=GRP)
            except PeerGone:
                pass


def run_follower(rank: int, spec: GroupSpec, engine_factory,
                 plane: ObjectPlane,
                 kill_after_ops: Optional[int] = None) -> dict:
    """Follower shard loop: build the group's engine and replay every
    mirrored step the leader emits, in order.  Returns a summary dict
    (``applied`` steps, exit ``reason``).

    Exits cleanly on the leader's ``("stop",)``, or with reason
    ``"leader gone"`` on :class:`PeerGone` (leader death — the router
    fails the whole group and this shard has nothing left to serve).
    ``kill_after_ops`` is the soak hook: SIGKILL THIS process after
    replaying that many steps — mid-stream, no cleanup — so the
    follower-death failover path can be exercised end to end."""
    lead = plane.members.index(spec.leader)
    # First beat BEFORE engine construction: it opens the inbound
    # connection the leader's death detection watches, and the leader
    # may already be fanning out steps (they buffer until we drain).
    try:
        plane.send(("beat",), lead, tag=GRP)
    except PeerGone:
        return {"applied": 0, "reason": "leader gone"}
    engine = engine_factory()
    applied = 0
    last_beat = time.monotonic()
    while True:
        now = time.monotonic()
        if now - last_beat > GROUP_BEAT_S:
            try:
                plane.send(("beat",), lead, tag=GRP)
            except PeerGone:
                return {"applied": applied, "reason": "leader gone"}
            last_beat = now
        try:
            msg = plane.recv(lead, tag=GRP, timeout_ms=20)
        except TimeoutError:
            continue
        except PeerGone:
            return {"applied": applied, "reason": "leader gone"}
        if msg[0] == "stop":
            return {"applied": applied, "reason": "stopped"}
        _, op, payload = msg
        engine.apply_step(op, payload)
        applied += 1
        if kill_after_ops is not None and applied >= kill_after_ops:
            # Crash simulation: die NOW, mid-replay, no cleanup.
            os.kill(os.getpid(), signal.SIGKILL)
