"""Rolling-window anomaly detection over the live fleet view — port of
``chainermn_tpu/observability/anomaly.py`` (host code, copied as it is).

The router's fleet summary (heartbeat-merged Reporter snapshots) is a
cumulative view: counters only grow, histogram buckets only fill.  The
detectors here difference consecutive snapshots into per-interval
signals and compare a short *recent* window against a longer *baseline*
window — the standard burn-alert shape, but over the fleet rather than
one process:

* **latency regression** — the per-interval median of the
  ``trace/<stage>`` power-of-two histogram (new observations only)
  rising above ``regression_factor`` × the baseline median.
* **goodput drop** — the per-interval ``serving/tokens`` rate falling
  below ``drop_factor`` × the baseline median rate.

Each :meth:`AnomalyDetector.update` publishes ``anomaly/*`` gauges
(current 0/1 state plus the raw ratios) and counts a rising edge once
per alarm onset, so the event stream stays sparse.  The autoscaler takes
:meth:`AnomalyDetector.alarming` as an additional scale-up input
alongside its SLO burn-rate override — an anomaly is evidence the fleet
is degrading even when no SLO has formally burned yet.

Host-side Python only: nothing reaches the device, no collectives.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional

__all__ = ["AnomalyDetector"]


def _hist_median(delta: Dict[int, int]) -> Optional[float]:
    """Weighted median upper-bound of a pow2 bucket-count delta."""
    total = sum(delta.values())
    if total <= 0:
        return None
    seen = 0
    for b in sorted(delta):
        seen += delta[b]
        if seen * 2 >= total:
            return 2.0 ** b
    return 2.0 ** max(delta)


class AnomalyDetector:
    """Differencing detector over cumulative fleet summaries.

    ``source`` (optional) is a zero-arg callable returning the fleet
    summary so driving code can call :meth:`update` with no arguments;
    passing the summary explicitly works the same.  ``reporter`` gets
    the ``anomaly/*`` series.  All windows are in *updates*, not
    seconds — call :meth:`update` on a fixed cadence (the autoscaler's
    interval) for time-meaningful windows.
    """

    def __init__(self, source: Optional[Callable[[], dict]] = None,
                 reporter=None, latency_stage: str = "decode",
                 window: int = 8, baseline: int = 64,
                 regression_factor: float = 2.0,
                 drop_factor: float = 0.5,
                 min_samples: int = 4,
                 clock: Callable[[], float] = time.monotonic):
        self._source = source
        self.reporter = reporter
        self.latency_stage = latency_stage
        self.window = max(1, int(window))
        self.baseline = max(self.window + 1, int(baseline))
        self.regression_factor = float(regression_factor)
        self.drop_factor = float(drop_factor)
        self.min_samples = max(1, int(min_samples))
        self.clock = clock
        self._prev_hist: Dict[int, int] = {}
        self._prev_tokens: Optional[float] = None
        self._prev_t: Optional[float] = None
        self._medians: deque = deque(maxlen=self.baseline)
        self._rates: deque = deque(maxlen=self.baseline)
        self._state = {"latency_regression": False, "goodput_drop": False}

    # -- the per-interval signals --------------------------------------
    def _latency_median(self, fleet: dict) -> Optional[float]:
        hist = fleet.get("histograms", {}).get(
            f"trace/{self.latency_stage}", {})
        cur = {int(b): int(c) for b, c in hist.items()}
        delta = {b: c - self._prev_hist.get(b, 0)
                 for b, c in cur.items()
                 if c - self._prev_hist.get(b, 0) > 0}
        self._prev_hist = cur
        return _hist_median(delta)

    def _goodput_rate(self, fleet: dict, now: float) -> Optional[float]:
        tokens = float(fleet.get("counters", {}).get("serving/tokens", 0.0))
        prev, prev_t = self._prev_tokens, self._prev_t
        self._prev_tokens, self._prev_t = tokens, now
        if prev is None or prev_t is None or now <= prev_t:
            return None
        # A replica loss can shrink the merged counter; a negative delta
        # is a fleet-membership change, not negative work.
        return max(0.0, tokens - prev) / (now - prev_t)

    @staticmethod
    def _split(history: deque, window: int):
        xs = list(history)
        return xs[:-window], xs[-window:]

    @staticmethod
    def _median(xs: List[float]) -> float:
        ys = sorted(xs)
        return ys[len(ys) // 2]

    # -- public --------------------------------------------------------
    def update(self, fleet: Optional[dict] = None,
               now: Optional[float] = None) -> dict:
        """Fold one fleet snapshot; returns the current alarm state
        (also kept for :meth:`alarming`)."""
        if fleet is None:
            if self._source is None:
                raise ValueError("no fleet summary and no source callable")
            fleet = self._source()
        now = self.clock() if now is None else now

        med = self._latency_median(fleet)
        if med is not None:
            self._medians.append(med)
        rate = self._goodput_rate(fleet, now)
        if rate is not None:
            self._rates.append(rate)

        lat_ratio = self._ratio(self._medians)
        rate_ratio = self._ratio(self._rates)
        latency_regression = (
            lat_ratio is not None and lat_ratio > self.regression_factor
        )
        goodput_drop = (
            rate_ratio is not None and rate_ratio < self.drop_factor
        )

        rep = self.reporter
        if rep is not None:
            if latency_regression and not self._state["latency_regression"]:
                rep.count("anomaly/latency_regression", 1)
            if goodput_drop and not self._state["goodput_drop"]:
                rep.count("anomaly/goodput_drop", 1)
            rep.gauge("anomaly/latency_regression",
                      1.0 if latency_regression else 0.0)
            rep.gauge("anomaly/goodput_drop",
                      1.0 if goodput_drop else 0.0)
            if lat_ratio is not None:
                rep.gauge("anomaly/latency_ratio", lat_ratio)
            if rate_ratio is not None:
                rep.gauge("anomaly/goodput_ratio", rate_ratio)

        self._state = {
            "latency_regression": latency_regression,
            "goodput_drop": goodput_drop,
        }
        return dict(self._state,
                    latency_ratio=lat_ratio, goodput_ratio=rate_ratio)

    def _ratio(self, history: deque) -> Optional[float]:
        """recent-median / baseline-median, or None before warm."""
        if len(history) < self.window + self.min_samples:
            return None
        base, recent = self._split(history, self.window)
        base_med = self._median(base)
        if base_med <= 0:
            return None
        return self._median(recent) / base_med

    def alarming(self) -> bool:
        """True while either detector is in alarm — the autoscaler's
        additional scale-up input."""
        return any(self._state.values())
