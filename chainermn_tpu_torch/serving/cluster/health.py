"""Replica liveness + watermark-driven autoscaling signals.

Liveness is heartbeat-based: anything that proves a replica executed
recently counts as a beat — in-process replicas beat on every step;
remote replicas beat whenever an event batch arrives over the object
plane (and the plane's ``PeerGone`` short-circuits the wait entirely
when the TCP connection dies, which is faster than any timeout).
:class:`HeartbeatMonitor` itself lives in
:mod:`chainermn_tpu_torch.elastic.heartbeat` — the elastic training
supervisor monitors rank liveness with the SAME deadline machinery —
and is re-exported here for the serving tier's callers.

Scaling is *signals, not actions*: :func:`scale_signals` folds the
fleet's load snapshots into a scale-up flag and a drain candidate,
published as Reporter gauges (``serving/cluster/*``) for whatever
actuator watches them — a k8s HPA reading the Prometheus export, a
notebook calling ``router.drain()``, or nothing.  The policy is the
standard watermark pair: scale up when free pages or queue slots run
low fleet-wide, drain the least-loaded replica when the fleet is so
idle that N-1 replicas could absorb it.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from ...elastic.heartbeat import HeartbeatMonitor  # noqa: F401


def scale_signals(loads, *, low_free_frac: float = 0.1,
                  high_free_frac: float = 0.5,
                  queue_pressure_frac: float = 0.8,
                  reporter=None) -> dict:
    """Fold the alive replicas' :class:`ReplicaLoad` snapshots into
    autoscaling signals.

    * ``scale_up`` — True when fleet-wide free pages sink below
      ``low_free_frac`` of the pool or any replica's queue passes
      ``queue_pressure_frac`` of capacity: the moment new requests
      start paying preemption/backpressure tax.
    * ``drain_candidate`` — the least-loaded decode-capable replica id
      when the fleet holds more than ``high_free_frac`` free pages even
      with that replica removed, queues are empty, and >1 decode
      replica remains; None otherwise.  Draining (the router stops
      routing to it; it finishes its streams) is the graceful half of
      scale-down.

    Gauges published under ``serving/cluster/*`` when ``reporter`` is
    given.
    """
    loads = [ld for ld in loads if ld.alive]
    decode = [ld for ld in loads if ld.role in ("decode", "both")]
    total = sum(ld.n_blocks for ld in loads)
    free = sum(ld.free_blocks for ld in loads)
    free_frac = free / total if total else 0.0
    queued = sum(ld.queue_depth for ld in loads)
    worst_queue = max((ld.queue_frac for ld in loads), default=0.0)

    scale_up = bool(loads) and (
        free_frac < low_free_frac or worst_queue >= queue_pressure_frac
    )

    drain_candidate = None
    if len(decode) > 1 and queued == 0:
        # Least-loaded: fewest running, then most free pages, then id —
        # deterministic so repeated checks nominate the same replica.
        cand = min(
            decode,
            key=lambda ld: (ld.running, -ld.free_blocks,
                            repr(ld.replica_id)),
        )
        rest_total = total - cand.n_blocks
        rest_free = free - cand.free_blocks
        if (
            cand.running == 0
            and rest_total > 0
            and rest_free / rest_total > high_free_frac
        ):
            drain_candidate = cand.replica_id

    out = {
        "scale_up": scale_up,
        "drain_candidate": drain_candidate,
        "free_frac": free_frac,
        "queued": queued,
        "replicas_alive": len(loads),
    }
    if reporter is not None:
        reporter.gauge("serving/cluster/scale_up", int(scale_up))
        reporter.gauge("serving/cluster/drain_pending",
                       int(drain_candidate is not None))
        reporter.gauge("serving/cluster/free_frac", free_frac)
        reporter.gauge("serving/cluster/queued", queued)
        reporter.gauge("serving/cluster/replicas_alive", len(loads))
    return out


class ScaleSignalFilter:
    """Hysteresis + cooldown debouncer between :func:`scale_signals`
    and any actuator.

    Raw watermark signals flap: one bursty arrival batch trips
    ``scale_up`` for a single observation, one idle tick nominates a
    drain candidate that is busy again a millisecond later.  An
    actuator that obeys every observation oscillates — spawn, drain,
    spawn — paying replica cold-start on each swing.  The filter passes
    a decision through only when it has been observed ``k_up`` /
    ``k_down`` times *consecutively* (a drain vote must nominate the
    SAME candidate each time — a flap between candidates resets the
    count), and refuses any decision inside ``cooldown_s`` of the last
    one, so the fleet settles between actions.
    """

    def __init__(self, k_up: int = 3, k_down: int = 5,
                 cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic):
        if k_up < 1 or k_down < 1:
            raise ValueError("hysteresis counts must be >= 1")
        self.k_up = int(k_up)
        self.k_down = int(k_down)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock
        self._up_streak = 0
        self._down_streak = 0
        self._down_candidate = None
        self._last_decision_t: Optional[float] = None

    def _in_cooldown(self, now: float) -> bool:
        return (
            self._last_decision_t is not None
            and now - self._last_decision_t < self.cooldown_s
        )

    def update(self, signals: dict,
               now: Optional[float] = None) -> dict:
        """Feed one :func:`scale_signals` observation; returns
        ``{"scale_up": bool, "drain": candidate_or_None}`` with the
        debounced decision (at most one direction per call).  Streaks
        survive a cooldown window — sustained pressure acts the moment
        the window expires — but emitting a decision resets both."""
        now = self.clock() if now is None else now

        if signals.get("scale_up"):
            self._up_streak += 1
        else:
            self._up_streak = 0

        cand = signals.get("drain_candidate")
        if cand is not None and cand == self._down_candidate:
            self._down_streak += 1
        elif cand is not None:
            self._down_candidate = cand
            self._down_streak = 1
        else:
            self._down_candidate = None
            self._down_streak = 0

        out = {"scale_up": False, "drain": None}
        if self._in_cooldown(now):
            return out
        if self._up_streak >= self.k_up:
            out["scale_up"] = True
        elif self._down_streak >= self.k_down:
            out["drain"] = self._down_candidate
        if out["scale_up"] or out["drain"] is not None:
            self._last_decision_t = now
            self._up_streak = 0
            self._down_streak = 0
            self._down_candidate = None
        return out
