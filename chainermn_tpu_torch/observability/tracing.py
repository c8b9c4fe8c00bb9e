"""Cross-replica request tracing with a crash-surviving flight recorder —
port of ``chainermn_tpu/observability/tracing.py`` (host code, copied as it
is).

Every serving request yields a **span tree**: a root ``request`` span
minted where the request enters the system (``ServeFrontend.submit`` or
the cluster router), plus flat stage children — ``queue``, ``placement``,
``prefill``, ``handoff``, ``migrate_send``/``migrate_recv``, per-iteration
``decode``, and a derived ``deliver`` span covering first→last streamed
token.  The context travels as a tiny value object (:class:`SpanCtx`:
trace id + parent span id) through the reference's router CMD frames,
``serving.cluster.disagg.PrefillJob`` handoffs and KV-page migration (the
cluster tier is a later slice of the port), so one request's tree spans every process it touched.

Crash-robust parenting rule
---------------------------
A span only becomes durable when it *ends* (that is when its row is
written).  If stage spans parented to other stage spans, a replica
SIGKILLed mid-request would leave written children pointing at a parent
that was still open — an orphan.  So every replica-side stage span
parents **directly to the root context** carried on the wire, and the
root is owned by the process that survives failover (the router).  The
tree is therefore deliberately root + flat stage children: stitching the
flight files of a dead replica and the adopting replica yields one
connected tree with no orphan spans.

Flight recorder
---------------
:class:`FlightRecorder` is a bounded in-memory ring plus a
:class:`~chainermn_tpu_torch.observability.step_log.StepRecorder`-backed JSONL
file: one atomic ``O_APPEND`` write per finished span, rotation bounding
disk.  A SIGKILL loses at most one truncated final line (skipped by the
reader) — everything the replica finished before dying is recoverable
for postmortems.

Exports: :func:`stitch` + :func:`validate_trace` reassemble trees from
flight files, and :class:`SLOConfig` drives burn-rate gauges through the
Reporter.  The reference's postmortem tools (Chrome-trace export, stage
percentiles, the straggler detector) come with the port of
``tools/obs`` (ROADMAP A.7).

Zero-overhead when disabled: every instrumented call site starts with
``tr = get_tracer()`` and does nothing when it returns ``None`` — no
ids are minted, no clocks are read, and nothing reaches the device.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from . import step_log as _step_log

__all__ = [
    "SpanCtx",
    "Tracer",
    "FlightRecorder",
    "SLOConfig",
    "get_tracer",
    "install",
    "uninstall",
    "trace_scope",
    "tracing_active",
    "read_flight",
    "stitch",
    "validate_trace",
    "percentile",
    "detect_stragglers",
]


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SpanCtx:
    """Wire-portable trace context: which trace, and which span new
    children should parent to."""

    trace_id: str
    span_id: str

    def to_wire(self) -> dict:
        return {"tid": self.trace_id, "sid": self.span_id}

    @staticmethod
    def from_wire(obj) -> Optional["SpanCtx"]:
        """Accept a wire dict, an existing SpanCtx, or None."""
        if obj is None:
            return None
        if isinstance(obj, SpanCtx):
            return obj
        return SpanCtx(trace_id=str(obj["tid"]), span_id=str(obj["sid"]))


@dataclass
class SLOConfig:
    """Latency objectives per stage (seconds) driving burn-rate gauges.

    ``burn rate = (violating fraction over the trailing window) /
    budget`` — 1.0 means exactly consuming the error budget, >1 means
    burning it faster than allowed.
    """

    targets: Dict[str, float] = field(default_factory=dict)
    budget: float = 0.01
    window: int = 256


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------
class FlightRecorder:
    """Per-replica crash-surviving span sink.

    Rides :class:`StepRecorder`'s O_APPEND + rotation machinery (memory
    sampling disabled — this file holds only span and event rows).  ``rotate_bytes`` bounds disk for soak runs; each row is
    one atomic write, so a SIGKILL costs at most the final line.
    """

    def __init__(self, path: str, replica=None,
                 rotate_bytes: Optional[int] = 4 * 1024 * 1024,
                 max_files: int = 2):
        rank = replica if isinstance(replica, int) else 0
        self.path = str(path)
        self.replica = replica
        self._rec = _step_log.StepRecorder(
            path,
            rotate_bytes=rotate_bytes,
            max_files=max_files,
            rank=rank,
            mem_every=0,
        )

    def write(self, kind: str, row: dict) -> None:
        self._rec.record(kind, **row)

    def close(self) -> None:
        self._rec.close()


def read_flight(path: str) -> List[dict]:
    """Span/event rows from one flight file (rotated segments included,
    truncated final line skipped — the SIGKILL case)."""
    rows = _step_log.read_records(path, include_rotated=True, strict=False)
    return [r for r in rows if r.get("event") in ("span", "evt")]


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------
class Tracer:
    """Mints trace/span ids and records finished spans to an in-memory
    ring, an optional :class:`FlightRecorder`, and an optional Reporter
    (``trace/<stage>`` pow2 histograms + SLO burn gauges).

    Thread-safe: the serving cluster drives replicas from threads.
    ``nonce`` seeds id minting — pass a fixed value for deterministic ids
    in golden tests; by default ids embed the pid so concurrent processes
    never collide.
    """

    def __init__(self, flight: Optional[FlightRecorder] = None,
                 reporter=None, replica=None,
                 slo: Optional[SLOConfig] = None,
                 ring: int = 4096, clock=time.time,
                 nonce: Optional[str] = None):
        self.flight = flight
        self.reporter = reporter
        self.replica = replica
        self.slo = slo
        self.clock = clock
        self._nonce = nonce if nonce is not None else f"{os.getpid():x}"
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, int(ring)))
        self._open: Dict[str, dict] = {}        # span_id -> open row
        self._tokens: Dict[str, dict] = {}      # trace_id -> deliver stats
        self._slo_win: Dict[str, deque] = {}

    # -- id minting ----------------------------------------------------
    def _sid(self) -> str:
        return f"{self._nonce}.{next(self._ids)}"

    def new_trace(self) -> str:
        return f"t{self._nonce}.{next(self._ids)}"

    # -- span lifecycle ------------------------------------------------
    def begin(self, name: str, parent: Optional[SpanCtx] = None,
              replica=None, **attrs) -> SpanCtx:
        """Open a span.  With ``parent=None`` a fresh trace is minted
        (this is the root).  Returns the context children parent to.
        Nothing is written until :meth:`end` — see the crash-robust
        parenting rule in the module docstring."""
        sid = self._sid()
        tid = parent.trace_id if parent is not None else self.new_trace()
        row = {
            "trace": tid,
            "span": sid,
            "parent": parent.span_id if parent is not None else None,
            "name": name,
            "t0": self.clock(),
            "replica": self.replica if replica is None else replica,
        }
        if attrs:
            row["attrs"] = dict(attrs)
        with self._lock:
            self._open[sid] = row
        return SpanCtx(trace_id=tid, span_id=sid)

    def end(self, ctx: Optional[SpanCtx], error=None, **attrs) -> None:
        """Close a span opened with :meth:`begin`.  Unknown / already
        closed ids are a no-op (double-end safe)."""
        if ctx is None:
            return
        with self._lock:
            row = self._open.pop(ctx.span_id, None)
        if row is None:
            return
        row["dur"] = max(0.0, self.clock() - row["t0"])
        if error:
            row["error"] = True
            if not isinstance(error, bool):
                row.setdefault("attrs", {})["error_msg"] = str(error)
        if attrs:
            row.setdefault("attrs", {}).update(attrs)
        if row["name"] == "request":
            self._emit_deliver(ctx)
        self._write(row)

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[SpanCtx] = None,
             replica=None, **attrs):
        """``with tr.span("prefill", parent=root):`` — closes and marks
        ``error=True`` on exception paths, then re-raises."""
        ctx = self.begin(name, parent, replica=replica, **attrs)
        try:
            yield ctx
        except BaseException as exc:
            self.end(ctx, error=exc)
            raise
        else:
            self.end(ctx)

    def record_span(self, name: str, parent: Optional[SpanCtx],
                    t0: float, dur: float, replica=None,
                    error=None, **attrs) -> None:
        """Record an externally-timed span in one shot (queue wait,
        shared batched-decode duration)."""
        if parent is None:
            return
        row = {
            "trace": parent.trace_id,
            "span": self._sid(),
            "parent": parent.span_id,
            "name": name,
            "t0": float(t0),
            "dur": max(0.0, float(dur)),
            "replica": self.replica if replica is None else replica,
        }
        if error:
            row["error"] = True
        if attrs:
            row["attrs"] = dict(attrs)
        self._write(row)

    def event(self, name: str, parent: Optional[SpanCtx],
              replica=None, **attrs) -> None:
        """Instantaneous annotation (``preempted``, ``failover``, …)."""
        if parent is None:
            return
        row = {
            "trace": parent.trace_id,
            "parent": parent.span_id,
            "name": name,
            "ts": self.clock(),
            "replica": self.replica if replica is None else replica,
        }
        if attrs:
            row["attrs"] = dict(attrs)
        with self._lock:
            self._ring.append(("evt", row))
        if self.flight is not None:
            self.flight.write("evt", row)

    def token(self, ctx: Optional[SpanCtx]) -> None:
        """Mark one streamed token delivered for ``ctx``'s trace; first
        and last arrivals become the derived ``deliver`` span when the
        root ends."""
        if ctx is None:
            return
        now = self.clock()
        with self._lock:
            st = self._tokens.get(ctx.trace_id)
            if st is None:
                self._tokens[ctx.trace_id] = {
                    "first": now, "last": now, "n": 1,
                    "parent": ctx.span_id,
                }
            else:
                st["last"] = now
                st["n"] += 1

    def _emit_deliver(self, root: SpanCtx) -> None:
        with self._lock:
            st = self._tokens.pop(root.trace_id, None)
        if st is None:
            return
        self._write({
            "trace": root.trace_id,
            "span": self._sid(),
            "parent": root.span_id,
            "name": "deliver",
            "t0": st["first"],
            "dur": max(0.0, st["last"] - st["first"]),
            "replica": self.replica,
            "attrs": {"tokens": st["n"]},
        })

    # -- sinks ---------------------------------------------------------
    def _write(self, row: dict) -> None:
        with self._lock:
            self._ring.append(("span", row))
        if self.flight is not None:
            self.flight.write("span", row)
        rep = self.reporter
        if rep is not None:
            name = row["name"]
            rep.histogram_observe(f"trace/{name}", row["dur"])
            if row.get("error"):
                rep.count(f"trace/{name}/errors", 1)
            tenant = (row.get("attrs") or {}).get("tenant")
            self._slo_observe(name, row["dur"], rep, tenant=tenant)

    def _slo_observe(self, name: str, dur: float, rep,
                     tenant=None) -> None:
        slo = self.slo
        if slo is None or name not in slo.targets:
            return
        bad = dur > slo.targets[name]
        with self._lock:
            win = self._slo_win.setdefault(
                name, deque(maxlen=max(1, slo.window)))
            win.append(bad)
            frac = sum(win) / len(win)
            tfrac = None
            if tenant is not None:
                # Per-tenant burn window: same SLO target and budget,
                # windowed over THIS tenant's spans only, so one noisy
                # tenant's violations don't hide inside the aggregate.
                twin = self._slo_win.setdefault(
                    (name, tenant), deque(maxlen=max(1, slo.window)))
                twin.append(bad)
                tfrac = sum(twin) / len(twin)
        if bad:
            rep.count(f"slo/violations/{name}", 1)
        scale = 1.0 / slo.budget if slo.budget > 0 else 0.0
        rep.gauge(f"slo/burn_rate/{name}", frac * scale)
        if tfrac is not None:
            rep.gauge(f"slo/burn_rate/{name}/tenant/{tenant}",
                      tfrac * scale)

    # -- read side -----------------------------------------------------
    def records(self) -> List[dict]:
        """Ring snapshot as flat rows (``event`` key restored) — same
        shape :func:`read_flight` returns from disk."""
        with self._lock:
            items = list(self._ring)
        out = []
        for kind, row in items:
            r = dict(row)
            r["event"] = kind
            out.append(r)
        return out

    def stage_stats(self) -> Dict[Tuple[Any, str], List[float]]:
        """``{(replica, stage): [durations]}`` over the ring — the
        straggler detector's input."""
        out: Dict[Tuple[Any, str], List[float]] = {}
        with self._lock:
            items = list(self._ring)
        for kind, row in items:
            if kind != "span":
                continue
            out.setdefault((row.get("replica"), row["name"]), []).append(
                row["dur"])
        return out

    def open_count(self) -> int:
        with self._lock:
            return len(self._open)

    def close(self) -> None:
        if self.flight is not None:
            self.flight.close()


# ---------------------------------------------------------------------------
# Current-tracer stack (mirrors reporter.scope)
# ---------------------------------------------------------------------------
_stack: list = []
_stack_lock = threading.Lock()


def get_tracer() -> Optional[Tracer]:
    """The installed tracer, or None — the zero-overhead gate every
    instrumented call site checks first."""
    with _stack_lock:
        return _stack[-1] if _stack else None


def install(tracer: Tracer) -> None:
    with _stack_lock:
        _stack.append(tracer)


def uninstall(tracer: Tracer) -> None:
    with _stack_lock:
        if tracer in _stack:
            _stack.remove(tracer)


@contextlib.contextmanager
def trace_scope(tracer: Tracer):
    install(tracer)
    try:
        yield tracer
    finally:
        uninstall(tracer)


def tracing_active() -> bool:
    return get_tracer() is not None


# ---------------------------------------------------------------------------
# Stitching / validation / export
# ---------------------------------------------------------------------------
def stitch(records: List[dict]) -> Dict[str, dict]:
    """Group flat rows (from any number of flight files / rings) into
    ``{trace_id: {"spans": [...], "events": [...]}}``."""
    out: Dict[str, dict] = {}
    for r in records:
        tid = r.get("trace")
        if tid is None:
            continue
        slot = out.setdefault(tid, {"spans": [], "events": []})
        if r.get("event") == "evt":
            slot["events"].append(r)
        else:
            slot["spans"].append(r)
    for slot in out.values():
        slot["spans"].sort(key=lambda s: s.get("t0", 0.0))
        slot["events"].sort(key=lambda e: e.get("ts", 0.0))
    return out


def validate_trace(spans: List[dict], skew_s: float = 0.5) -> dict:
    """Postmortem checks for one stitched trace.

    * ``orphans`` — spans whose parent id was never written (the failure
      mode the crash-robust parenting rule exists to prevent).
    * ``monotone`` — every child starts no earlier than its parent
      (within ``skew_s`` cross-process clock tolerance) and finishes by
      the parent's end + skew.
    """
    ids = {s["span"] for s in spans}
    orphans = [s for s in spans
               if s.get("parent") is not None and s["parent"] not in ids]
    by_id = {s["span"]: s for s in spans}
    violations = []
    for s in spans:
        p = by_id.get(s.get("parent"))
        if p is None:
            continue
        if s["t0"] + skew_s < p["t0"]:
            violations.append((s["span"], "starts before parent"))
        if s["t0"] + s.get("dur", 0.0) > p["t0"] + p.get("dur", 0.0) + skew_s:
            violations.append((s["span"], "ends after parent"))
    roots = [s for s in spans if s.get("parent") is None]
    return {
        "spans": len(spans),
        "roots": len(roots),
        "orphans": [s["span"] for s in orphans],
        "monotone": not violations,
        "violations": violations,
        "connected": not orphans and len(roots) >= 1,
    }


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100])."""
    if not values:
        return 0.0
    xs = sorted(values)
    k = max(0, min(len(xs) - 1, math.ceil(q / 100.0 * len(xs)) - 1))
    return xs[k]


def detect_stragglers(stats: Dict[Tuple[Any, str], List[float]],
                      k: float = 4.0,
                      min_samples: int = 4) -> Dict[Any, Dict[str, float]]:
    """Flag replicas whose per-stage median exceeds ``k``x the fleet
    median of that stage.  Input is :meth:`Tracer.stage_stats` output;
    returns ``{replica: {stage: ratio}}`` for flagged pairs only (the
    serving router publishes them as gauges)."""
    by_stage: Dict[str, Dict[Any, float]] = {}
    for (rep, stage), xs in stats.items():
        if rep is None or len(xs) < min_samples:
            continue
        by_stage.setdefault(stage, {})[rep] = percentile(xs, 50)
    flagged: Dict[Any, Dict[str, float]] = {}
    for stage, meds in by_stage.items():
        if len(meds) < 2:
            continue  # no fleet to compare against
        fleet = percentile(list(meds.values()), 50)
        if fleet <= 0:
            continue
        for rep, m in meds.items():
            ratio = m / fleet
            if ratio > k:
                flagged.setdefault(rep, {})[stage] = ratio
    return flagged
