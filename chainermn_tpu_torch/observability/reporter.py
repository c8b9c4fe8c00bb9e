"""Metrics registry — port of ``chainermn_tpu/observability/reporter.py``
(pure host code, copied as it is).

Reference: Chainer's ``Reporter``/``DictSummary`` (REF:chainer/reporter.py,
consumed by ChainerMN's examples through ``LogReport``) — a process-local
registry of named observations that extensions read and reset per report
interval.  The difference is the aggregation plane: the
reference ran one process per GPU and let ``LogReport`` average locally,
leaning on the evaluator's ``allreduce_obj`` for the cross-process view.
Here one :class:`Reporter` per process accumulates host-side observations
(scalars, counters, histograms) and :meth:`Reporter.aggregate` merges them
across processes through the communicator's object plane — mean/sum/max
reductions usable on rank 0 (and returned on every rank, keeping callers
SPMD-branch-free), a local no-op on the naive/single-host communicators
where the object plane degenerates to a local no-op.

Three metric kinds, chosen to merge exactly under concatenation so the
cross-host reduction is lossless:

* **scalar** — ``observe(name, v)`` keeps ``(count, sum, min, max, last)``;
  the mean is ``sum/count`` so a weighted cross-host mean needs no
  per-observation storage.
* **counter** — ``count(name, n)`` a monotonic sum (events, steps, bytes).
* **histogram** — ``histogram_observe(name, v)`` buckets ``v`` into
  power-of-two bins (log2 of the upper bound), the standard
  latency-histogram shape; bucket counts sum across hosts.
* **gauge** — ``gauge(name, v)`` a set-style level (queue depth, cache
  occupancy): the LAST value wins locally — re-setting replaces, never
  accumulates — and ranks merge to ``sum`` with ``min``/``max``, the
  natural reading for capacity-like levels (total in-flight across the
  job, plus the most/least loaded rank).

A module-level *current reporter* stack (``scope``/``get_reporter``/
``report``) mirrors the reference's ``reporter.report({...})`` idiom so
library code (the multi-node evaluator, span timings) can publish metrics
without threading a reporter handle through every call.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Mapping, Optional


class _Scalar:
    __slots__ = ("count", "sum", "min", "max", "last")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.last = 0.0

    def add(self, v: float):
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.last = v

    def merge(self, d: Mapping):
        if d["count"] == 0:
            return
        self.count += d["count"]
        self.sum += d["sum"]
        self.min = min(self.min, d["min"])
        self.max = max(self.max, d["max"])
        self.last = d["last"]  # merge order = rank order; rank-dependent

    def snapshot(self) -> dict:
        out = {"count": self.count, "sum": self.sum, "last": self.last,
               "min": self.min, "max": self.max}
        if self.count:
            out["mean"] = self.sum / self.count
        return out


class _Gauge:
    """Merge-side accumulator for set-style gauges.  A single rank's
    snapshot is ``{"value": v, "sum": v, "min": v, "max": v, "n": 1}``;
    merging sums ``sum``/``n`` and spreads ``min``/``max`` — composable,
    so a merge of merges equals one flat merge."""

    __slots__ = ("value", "sum", "min", "max", "n")

    def __init__(self):
        self.value = 0.0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.n = 0

    def merge(self, d: Mapping):
        if d.get("n", 0) == 0:
            return
        self.value = d["value"]  # merge order = rank order
        self.sum += d["sum"]
        self.min = min(self.min, d["min"])
        self.max = max(self.max, d["max"])
        self.n += d["n"]

    def snapshot(self) -> dict:
        return {"value": self.value, "sum": self.sum, "min": self.min,
                "max": self.max, "n": self.n}


def _bucket(v: float) -> int:
    """Histogram bucket id: ceil(log2(v)) clamped into [-30, 63] (bucket b
    covers (2^(b-1), 2^b]); non-positive values land in the lowest bucket."""
    if v <= 0:
        return -30
    return max(-30, min(63, math.ceil(math.log2(v))))


class Reporter:
    """Process-local metrics registry.  Thread-safe: the prefetch thread,
    monitoring listeners, and the train loop may all observe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._scalars: Dict[str, _Scalar] = {}
        self._counters: Dict[str, float] = {}
        self._hists: Dict[str, Dict[int, int]] = {}
        self._gauges: Dict[str, float] = {}

    # -- write side ----------------------------------------------------
    def observe(self, name: str, value) -> None:
        """Record one scalar observation (loss, step time, grad norm)."""
        v = float(value)
        with self._lock:
            self._scalars.setdefault(name, _Scalar()).add(v)

    def count(self, name: str, n=1) -> None:
        """Bump a monotonic counter (steps, compile events, bytes)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def histogram_observe(self, name: str, value) -> None:
        """Record one observation into the power-of-two histogram."""
        b = _bucket(float(value))
        with self._lock:
            h = self._hists.setdefault(name, {})
            h[b] = h.get(b, 0) + 1

    def gauge(self, name: str, value) -> None:
        """Set a level gauge (queue depth, cache occupancy): last value
        wins — setting replaces the previous value, never accumulates."""
        v = float(value)
        with self._lock:
            self._gauges[name] = v

    def report(self, values: Mapping[str, float]) -> None:
        """Batch scalar observations — the reference's ``report({...})``."""
        for k, v in values.items():
            self.observe(k, v)

    # -- read side -----------------------------------------------------
    def summary(self) -> dict:
        """Plain-dict snapshot: ``{"scalars": {...}, "counters": {...},
        "histograms": {...}}`` — JSON-safe, the merge/wire format."""
        with self._lock:
            return {
                "scalars": {
                    k: s.snapshot() for k, s in self._scalars.items()
                },
                "counters": dict(self._counters),
                # JSON object keys are strings; keep int buckets on the
                # in-memory side, stringify only here.
                "histograms": {
                    k: {str(b): c for b, c in h.items()}
                    for k, h in self._hists.items()
                },
                "gauges": {
                    k: {"value": v, "sum": v, "min": v, "max": v, "n": 1}
                    for k, v in self._gauges.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._scalars.clear()
            self._counters.clear()
            self._hists.clear()
            self._gauges.clear()

    def forget_replica(self, replica_id) -> int:
        """Drop every series labelled with ``replica_id`` (names ending
        in ``/replica/<id>`` or containing it as a path segment).

        A retired or SIGKILLed replica otherwise leaves its last
        ``serving/*/replica/<id>`` gauges in the registry forever — an
        operator's dashboard would show a dead replica at its final
        (healthy-looking) levels.  Returns the number of series dropped.
        """
        tail = f"/replica/{replica_id}"
        mid = tail + "/"

        def stale(name: str) -> bool:
            return name.endswith(tail) or mid in name

        dropped = 0
        with self._lock:
            for table in (self._scalars, self._counters, self._hists,
                          self._gauges):
                for name in [k for k in table if stale(k)]:
                    del table[name]
                    dropped += 1
        return dropped

    # -- cross-host ----------------------------------------------------
    def aggregate(self, comm, reset: bool = False) -> dict:
        """Merge every process's summary across ``comm``'s host plane.

        One object-plane allgather (the reference evaluator's
        ``allreduce_obj`` mechanism) carries each rank's snapshot; the
        merge is performed identically on every rank, so the result is
        valid everywhere while rank 0 does the logging (the reference
        pattern).  Scalars merge to the observation-weighted mean with
        global min/max; counters and histogram buckets sum.  Single-host
        communicators (naive / single_host / one-process xla_ici) take
        the trivial path — no collective.
        """
        local = self.summary()
        if getattr(comm, "size", 1) > 1:
            snaps = comm.gather_obj(local)  # allgather: list on every rank
        else:
            snaps = [local]
        merged = merge_summaries(snaps)
        if reset:
            self.reset()
        return merged


def merge_summaries(snapshots) -> dict:
    """Merge :meth:`Reporter.summary` dicts (one per rank) into one —
    the pure reduction :meth:`Reporter.aggregate` applies after its
    allgather, exposed for tests and offline tooling."""
    scalars: Dict[str, _Scalar] = {}
    counters: Dict[str, float] = {}
    hists: Dict[str, Dict[str, int]] = {}
    gauges: Dict[str, _Gauge] = {}
    for snap in snapshots:
        for k, d in snap.get("scalars", {}).items():
            scalars.setdefault(k, _Scalar()).merge(d)
        for k, v in snap.get("counters", {}).items():
            counters[k] = counters.get(k, 0) + v
        for k, h in snap.get("histograms", {}).items():
            out = hists.setdefault(k, {})
            for b, c in h.items():
                out[b] = out.get(b, 0) + c
        for k, d in snap.get("gauges", {}).items():
            gauges.setdefault(k, _Gauge()).merge(d)
    return {
        "scalars": {k: s.snapshot() for k, s in scalars.items()},
        "counters": counters,
        "histograms": hists,
        "gauges": {k: g.snapshot() for k, g in gauges.items()},
    }


# ---------------------------------------------------------------------------
# Current-reporter stack (the reference's thread-global reporter idiom)
# ---------------------------------------------------------------------------
_stack: list = []
_stack_lock = threading.Lock()


def get_reporter() -> Optional[Reporter]:
    """The innermost active reporter, or ``None`` (telemetry off)."""
    with _stack_lock:
        return _stack[-1] if _stack else None


@contextlib.contextmanager
def scope(reporter: Reporter):
    """Make ``reporter`` current for the with-block (re-entrant)."""
    with _stack_lock:
        _stack.append(reporter)
    try:
        yield reporter
    finally:
        with _stack_lock:
            _stack.remove(reporter)


def report(values: Mapping[str, float]) -> None:
    """Publish scalars to the current reporter; silent no-op when none is
    active — library call sites stay unconditional."""
    r = get_reporter()
    if r is not None:
        r.report(values)
