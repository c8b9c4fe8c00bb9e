"""Shared heartbeat/deadline liveness machinery.

This is the liveness core both tiers import: the serving cluster's
replica failover (``serving/cluster/health.py`` re-exports
:class:`HeartbeatMonitor` from here) and the elastic training
supervisor (:mod:`chainermn_tpu_torch.elastic.supervisor`).  Anything that
proves a peer executed recently counts as a beat — serving replicas
beat on every scheduler step or event batch; training ranks beat once
per training step through a :class:`FileBeat`, whose file mtime the
supervisor polls from outside the process boundary.

The monitor itself is transport-agnostic: callers feed ``beat()`` /
``mark_dead()`` and poll ``check()`` for *newly* dead peers (exactly
once per death — both the router's failover trigger and the
supervisor's restart path must not re-fire).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterable, List, Optional


@dataclasses.dataclass(frozen=True)
class BeatInfo:
    """Decoded contents of a beat file.

    ``mtime`` IS the liveness signal (what :func:`read_beat` returns);
    the payload fields are diagnostics.  The fabric fields (``plane``,
    ``lease_id``, ``world``) are trailing-defaulted so pre-fabric beat
    files — a bare step number, possibly empty — keep decoding: wire
    compatibility across the supervisor/rank version boundary."""

    mtime: float
    step: int = -1
    plane: str = ""
    lease_id: str = ""
    world: int = 0


class HeartbeatMonitor:
    """Deadline-based liveness over caller-supplied beats.

    ``miss_after_s`` without a beat marks a peer dead; :meth:`check`
    reports NEWLY dead peers exactly once (failover/restart triggers
    must not re-fire).  A beat from a dead peer revives it
    (replacement incarnation)."""

    def __init__(self, replica_ids: Iterable, miss_after_s: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.miss_after_s = float(miss_after_s)
        self.clock = clock
        now = clock()
        self._last: Dict[object, float] = {r: now for r in replica_ids}
        self._dead: set = set()

    def beat(self, replica_id, now: Optional[float] = None) -> None:
        self._last[replica_id] = self.clock() if now is None else now
        self._dead.discard(replica_id)

    def mark_dead(self, replica_id) -> None:
        """Out-of-band death report (e.g. a ``PeerGone`` from the
        transport, or a supervisor's ``proc.poll()``) — faster than
        waiting out the heartbeat deadline."""
        self._dead.add(replica_id)

    def forget(self, replica_id) -> None:
        """Stop tracking a peer that left *on purpose* (a drained and
        retired replica) — without this, its silence would read as a
        death and re-fire the failover path."""
        self._last.pop(replica_id, None)
        self._dead.discard(replica_id)

    def alive(self, replica_id) -> bool:
        return replica_id in self._last and replica_id not in self._dead

    def check(self, now: Optional[float] = None) -> List:
        """Returns replicas that died SINCE the last check."""
        now = self.clock() if now is None else now
        newly = [
            r for r, t in self._last.items()
            if r not in self._dead and now - t > self.miss_after_s
        ]
        self._dead.update(newly)
        return newly


class FileBeat:
    """Training-rank beat writer: one tiny file whose *mtime* is the
    beat signal, readable across the process boundary without any
    shared transport (the supervisor may not share a KV store or socket
    with the ranks it owns — a half-dead rank can't fake beats it isn't
    writing).

    The write is a whole-file rewrite of the current step (handy in
    postmortems); chaos's delayed-heartbeat fault suppresses beats via
    :meth:`suppress` without touching the training loop."""

    def __init__(self, path: str, clock: Callable[[], float] = time.time,
                 plane: str = "", lease_id: str = "", world: int = 0):
        self.path = str(path)
        self._clock = clock
        self._suppress_until = 0.0
        #: fabric identity stamped into each beat (who holds this
        #: chip); empty means pre-fabric legacy format.
        self.plane = str(plane)
        self.lease_id = str(lease_id)
        self.world = int(world)
        d = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(d, exist_ok=True)

    def suppress(self, secs: float) -> None:
        """Drop beats for ``secs`` (the chaos ``hb_stall`` fault — the
        process is alive but looks dead to the deadline)."""
        self._suppress_until = self._clock() + float(secs)

    def beat(self, step: Optional[int] = None) -> None:
        if self._clock() < self._suppress_until:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            if not (self.plane or self.lease_id or self.world):
                # Legacy format: bare step number (or empty).  Readers
                # of old supervisors only ever stat the mtime.
                f.write("" if step is None else str(int(step)))
            else:
                f.write(json.dumps({
                    "step": -1 if step is None else int(step),
                    "plane": self.plane,
                    "lease": self.lease_id,
                    "world": self.world,
                }, sort_keys=True))
        os.replace(tmp, self.path)  # atomic: readers never see a torn file


def read_beat(path: str) -> Optional[float]:
    """The beat file's mtime (wall clock), or None before the first
    beat.  Feed into a ``HeartbeatMonitor(clock=time.time)`` as
    ``monitor.beat(rank, now=mtime)``."""
    try:
        return os.stat(path).st_mtime
    except OSError:
        return None


def read_beat_info(path: str) -> Optional[BeatInfo]:
    """Decode a beat file into a :class:`BeatInfo` — parses both the
    legacy bare-step format and the fabric JSON payload, so a new
    supervisor reads old ranks' beats and vice versa."""
    mtime = read_beat(path)
    if mtime is None:
        return None
    try:
        with open(path) as f:
            raw = f.read().strip()
    except OSError:
        return None
    if not raw:
        return BeatInfo(mtime=mtime)
    if raw.startswith("{"):
        try:
            d = json.loads(raw)
        except ValueError:
            return BeatInfo(mtime=mtime)
        return BeatInfo(
            mtime=mtime,
            step=int(d.get("step", -1)),
            plane=str(d.get("plane", "")),
            lease_id=str(d.get("lease", "")),
            world=int(d.get("world", 0)),
        )
    try:
        return BeatInfo(mtime=mtime, step=int(raw))
    except ValueError:
        return BeatInfo(mtime=mtime)
