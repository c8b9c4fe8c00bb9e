"""Closed-loop SLO-guarded autoscaling over a replica fleet — port of
``chainermn_tpu/serving/cluster/autoscaler.py`` (host code, copied as it
is).

Scaling arrives as *signals* (``scale_signals`` folds load snapshots
into a scale-up flag and a drain candidate) and SLOs as *gauges*
(``slo/burn_rate/<stage>``).  The :class:`Autoscaler` closes the loop:

* **inputs** — fleet :class:`ReplicaLoad` snapshots via
  ``router.loads()``, the watermark signals from
  :func:`~chainermn_tpu_torch.serving.cluster.health.scale_signals`, and the
  per-stage SLO burn-rate gauges out of the Reporter (a burn rate ≥ 1
  means the stage is consuming its error budget faster than it
  accrues — the SLO-guard scales up even when page watermarks look
  healthy, because latency is the symptom users see first);
* **debounce** — every raw observation runs through a
  :class:`~chainermn_tpu_torch.serving.cluster.health.ScaleSignalFilter`
  (K consecutive votes + cooldown), so one bursty batch can't flap the
  fleet;
* **actions** — scale-up calls the injected ``replica_factory`` and
  joins the result via ``router.add_replica`` (a
  ``ThreadedClusterDriver`` wires the stepping thread on its next
  ``ensure_threads()``); scale-down runs the three-step graceful path:
  ``drain`` (router stops routing there) → ``migrate_out`` (live KV
  pages move to survivors over the migration path — streams keep
  committing, nothing is dropped or replayed from scratch) →
  ``retire_replica`` (refused until the replica is truly empty).
* **backfill** — dead capacity is an emergency, not a trend: when the
  alive count sinks below ``min_replicas`` (a SIGKILLed replica at
  peak load), the spawn bypasses hysteresis entirely.  Failover has
  already replayed the victim's streams; the backfill restores
  headroom so the SLO burn recovers.

The controller is synchronous and thread-free: call :meth:`step` from
whatever loop already pumps ``router.step(drive_replicas=False)``.
Decisions land in :attr:`events` (and as ``autoscaler/*`` Reporter
counters/gauges) so benches and tests can assert the exact action
sequence.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from .health import ScaleSignalFilter, scale_signals
from .replica import Replica


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    """Policy knobs; defaults suit the in-process bench fleets."""

    min_replicas: int = 1
    max_replicas: int = 4
    #: consecutive over/under-watermark observations before acting.
    k_up: int = 3
    k_down: int = 5
    #: quiet window after any decision (spawn, drain, retire).
    cooldown_s: float = 2.0
    #: watermark pair + queue threshold fed to ``scale_signals``.
    low_free_frac: float = 0.1
    high_free_frac: float = 0.5
    queue_pressure_frac: float = 0.8
    #: any stage burning its error budget at ≥ this rate votes
    #: scale-up, independent of the page/queue watermarks.
    burn_limit: float = 1.0


class Autoscaler:
    """SLO-guarded spawn/drain/retire controller for one router.

    ``replica_factory(replica_id) -> Replica`` owns engine
    construction (weights, pool geometry, role); the controller only
    decides *when*.  Ids are minted as ``"as<N>"`` so spawned replicas
    never collide with seed ids of any type.
    """

    def __init__(self, router, replica_factory: Callable[[object],
                                                         Replica],
                 config: Optional[AutoscalerConfig] = None,
                 reporter=None,
                 clock: Callable[[], float] = time.monotonic,
                 anomaly=None):
        self.router = router
        self.replica_factory = replica_factory
        self.config = config or AutoscalerConfig()
        #: optional :class:`~chainermn_tpu_torch.observability.anomaly.
        #: AnomalyDetector` — while it is alarming (fleet latency
        #: regression / goodput drop), scale-up is voted exactly like
        #: the burn-rate override.  The caller updates the detector;
        #: the controller only reads :meth:`alarming`.
        self.anomaly = anomaly
        self.reporter = reporter if reporter is not None \
            else router.reporter
        self.clock = clock
        c = self.config
        self._filter = ScaleSignalFilter(
            k_up=c.k_up, k_down=c.k_down, cooldown_s=c.cooldown_s,
            clock=clock,
        )
        self._spawned = 0
        #: replica currently mid-drain (at most one at a time — a
        #: second drain decision is refused until this one retires).
        self._draining = None
        self.events: List[dict] = []
        #: arbiter-granted replica ceiling.  None (default) means
        #: standalone operation: ``config.max_replicas`` caps growth as
        #: before.  Once a fabric arbiter calls :meth:`set_capacity` /
        #: :meth:`grant_capacity`, spawns are bounded by the granted
        #: capacity instead — the fleet can no longer grow on its own;
        #: it must be handed chips.
        self.capacity: Optional[int] = None
        #: callback invoked with the replica id after a retire
        #: completes; the arbiter uses it to reclaim the lease.
        self.on_retire: Optional[Callable[[object], None]] = None

    # -- inputs --------------------------------------------------------
    def _max_burn_rate(self) -> float:
        """Worst ``slo/burn_rate/<stage>`` gauge, 0.0 untracked."""
        if self.reporter is None:
            return 0.0
        gauges = self.reporter.summary().get("gauges", {})
        # summary() wraps each gauge as {"value": v, ...}.
        return max(
            (float(v["value"]) for k, v in gauges.items()
             if k.startswith("slo/burn_rate/")),
            default=0.0,
        )

    def _alive(self) -> int:
        return sum(
            1 for r in self.router.replicas.values()
            if r.alive and not r.draining
        )

    # -- actions -------------------------------------------------------
    def _event(self, action: str, now: float, **extra) -> dict:
        ev = {"action": action, "t": now, **extra}
        self.events.append(ev)
        if self.reporter is not None:
            self.reporter.count(f"autoscaler/{action}", 1)
        return ev

    def _spawn(self, now: float, reason: str) -> dict:
        rid = f"as{self._spawned}"
        self._spawned += 1
        rep = self.replica_factory(rid)
        self.router.add_replica(rep)
        return self._event("spawn", now, replica=rid, reason=reason)

    # -- arbiter-granted capacity --------------------------------------
    def set_capacity(self, n: int) -> None:
        """Pin the replica ceiling to ``n`` (arbiter bootstrap).  From
        here on the fleet grows only through :meth:`grant_capacity`."""
        self.capacity = max(int(n), self.config.min_replicas)

    def grant_capacity(self, n: int = 1, now: Optional[float] = None,
                       reason: str = "backfill") -> List[object]:
        """Raise the ceiling by ``n`` replicas and spawn them now
        (arbiter hands over freshly freed chips).  Returns the new
        replica ids so the caller can attach leases to them."""
        now = self.clock() if now is None else now
        base = self.capacity if self.capacity is not None \
            else self._alive()
        self.capacity = base + int(n)
        rids = []
        for _ in range(int(n)):
            ev = self._spawn(now, reason=reason)
            rids.append(ev["replica"])
        return rids

    def yield_capacity(self, n: int = 1) -> None:
        """Lower the ceiling by ``n`` after capacity left the fleet
        (retire completed, or a dead replica's lease was returned)."""
        if self.capacity is not None:
            self.capacity = max(
                self.capacity - int(n), self.config.min_replicas,
            )

    def _ceiling(self) -> int:
        return self.capacity if self.capacity is not None \
            else self.config.max_replicas

    def force_drain(self, replica_id,
                    now: Optional[float] = None) -> bool:
        """Operator/bench-requested scale-down: mark *replica_id*
        draining immediately, bypassing the hysteresis filter.  The
        normal :meth:`step` loop then progresses the migrate→retire
        sequence with the same zero-dropped-streams guarantees.
        Refused (False) while another drain is in flight, when the
        replica is unknown/dead, or when retiring it would sink the
        fleet below ``min_replicas``."""
        now = self.clock() if now is None else now
        if self._draining is not None:
            return False
        rep = self.router.replicas.get(replica_id)
        if rep is None or not rep.alive:
            return False
        if self._alive() <= self.config.min_replicas:
            return False
        self.router.drain(replica_id)
        self._draining = replica_id
        self._event("drain", now, replica=replica_id, reason="forced")
        return True

    # -- control loop --------------------------------------------------
    def step(self, now: Optional[float] = None) -> Optional[dict]:
        """One control iteration; returns the decision event taken this
        call (None when the fleet is left alone)."""
        now = self.clock() if now is None else now
        c = self.config
        loads = self.router.loads(now)
        signals = scale_signals(
            loads,
            low_free_frac=c.low_free_frac,
            high_free_frac=c.high_free_frac,
            queue_pressure_frac=c.queue_pressure_frac,
            reporter=self.reporter,
        )
        burn = self._max_burn_rate()
        if burn >= c.burn_limit:
            # Latency SLO burning through budget is a scale-up vote
            # even when pages/queues look fine.
            signals = dict(signals, scale_up=True)
        anomalous = self.anomaly is not None and self.anomaly.alarming()
        if anomalous:
            # Fleet-view anomaly (latency regression / goodput drop):
            # same override as the burn guard — symptoms users see
            # before the watermarks move.
            signals = dict(signals, scale_up=True)
        alive = self._alive()
        if self.reporter is not None:
            self.reporter.gauge("autoscaler/replicas", alive)
            self.reporter.gauge("autoscaler/max_burn_rate", burn)
            if self.capacity is not None:
                self.reporter.gauge("autoscaler/capacity", self.capacity)

        # Emergency backfill: below the floor means replicas DIED (the
        # chaos path).  No hysteresis — failover already replayed the
        # streams; capacity is what's missing.
        if alive < c.min_replicas:
            return self._spawn(now, reason="backfill")

        # Progress an in-flight drain ahead of new decisions: migrate
        # whatever still lives there, then try to retire.
        if self._draining is not None:
            rid = self._draining
            if rid not in self.router.replicas:
                self._draining = None  # died mid-drain; failover took it
            else:
                self.router.migrate_out(rid)
                if self.router.retire_replica(rid):
                    self._draining = None
                    ev = self._event("retire", now, replica=rid)
                    if self.on_retire is not None:
                        self.on_retire(rid)
                    return ev
                return None  # still emptying; hold other decisions

        decision = self._filter.update(signals, now=now)
        if decision["scale_up"]:
            if alive >= self._ceiling():
                return None
            if burn >= c.burn_limit:
                reason = "burn_rate"
            elif anomalous:
                reason = "anomaly"
            else:
                reason = "watermark"
            return self._spawn(now, reason=reason)
        cand = decision["drain"]
        if cand is not None and alive > c.min_replicas \
                and cand in self.router.replicas:
            self.router.drain(cand)
            self._draining = cand
            return self._event("drain", now, replica=cand)
        return None
