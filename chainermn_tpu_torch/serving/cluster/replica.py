"""One serving replica: engine + scheduler + frontend, with a role.

A :class:`Replica` is the unit the router places work on.  It owns the
single-engine stack from PR 5 unchanged — the cluster tier composes it,
it does not reimplement it — plus:

* a **role**: ``"decode"`` replicas take streaming requests, ``"prefill"``
  replicas only run disaggregated prompt prefills, ``"both"`` does both
  (the single-replica behavior);
* a **prefill job queue** (:meth:`enqueue_prefill`) drained one job per
  :meth:`step` — completed snapshots pile up in :attr:`handoffs` for the
  router to place on decode replicas;
* a **load snapshot** (:meth:`load`) — the free-page watermark, queue
  depth, batch occupancy, and minimum deadline slack the router scores;
* a **lock** — in threaded driving (bench, real deployments) the worker
  thread steps the replica while the router submits/places/fails over;
  every mutation path takes :attr:`lock`.

The replica itself is single-threaded deterministic Python, exactly like
the stack beneath it; the lock only serializes *who* calls it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import dataclasses

from .prefix_gossip import MAX_GOSSIP_DIGESTS
from .disagg import (
    PrefillJob,
    PrefillResult,
    run_prefill_job,
)
from ..engine import InferenceEngine
from ..frontend import ServeFrontend
from ..scheduler import ContinuousBatchingScheduler

ROLES = ("prefill", "decode", "both")


@dataclasses.dataclass(frozen=True)
class ReplicaLoad:
    """Point-in-time load snapshot — everything the router's scoring
    function consumes, and nothing it has to reach into the replica
    for.  Serializable (plain ints/floats) so remote replicas report
    the same structure over the object plane."""

    replica_id: object
    role: str
    alive: bool
    draining: bool
    free_blocks: int
    n_blocks: int
    queue_depth: int
    max_queue: int
    running: int
    max_batch: int
    #: smallest remaining deadline slack (s) among live requests; None
    #: when nothing has a deadline.
    min_slack_s: Optional[float] = None
    #: observed decode throughput (tokens/s); None before warm.
    tokens_per_sec: Optional[float] = None
    #: KV page size in tokens — lets a router translate a prompt into
    #: page digests without knowing the replica's engine config.  0 in
    #: snapshots from peers predating the gossip fields (wire compat).
    block_size: int = 0
    #: prefix-index anti-entropy stamp (kv.index_version at snapshot
    #: time) — receivers apply strictly-newer digest sets only.
    prefix_version: int = 0
    #: content digests of the replica's registered prefix-index keys
    #: (kv_cache.prefix_digest), capped at MAX_GOSSIP_DIGESTS.
    prefix_digests: Tuple[int, ...] = ()
    #: longest context (tokens) the replica's engine has actually run a
    #: prefill/chunk program over (engine.max_bucket) — long prompts
    #: prefer replicas already warm at that length, so a lazily-grown
    #: bucket ladder never recompiles fleet-wide.  0 = cold / snapshot
    #: from a peer predating the field (wire compat).
    max_bucket: int = 0
    #: metrics anti-entropy stamp — monotone per replica, applied
    #: strictly-newer-only by the router's MetricsGossip.  0 in beats
    #: from peers predating the fleet metrics plane (wire compat).
    metrics_version: int = 0
    #: the replica Reporter's full cumulative summary() at snapshot
    #: time, or None when the replica runs without a reporter / the
    #: beat came from an old peer (wire compat).
    metrics: Optional[dict] = None
    #: shard-group geometry: TP shards per pipeline stage and stage
    #: count (serving/cluster/shard_group.py).  1×1 = a one-process
    #: replica, and what beats from peers predating shard groups
    #: report (wire compat: trailing defaulted fields).
    group_size: int = 1
    pp_stages: int = 1

    @property
    def free_frac(self) -> float:
        return self.free_blocks / max(1, self.n_blocks)

    @property
    def queue_frac(self) -> float:
        return self.queue_depth / max(1, self.max_queue)

    @property
    def batch_frac(self) -> float:
        return self.running / max(1, self.max_batch)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ReplicaLoad":
        d = dict(d)
        if d.get("prefix_digests") is not None:
            d["prefix_digests"] = tuple(d["prefix_digests"])
        return cls(**d)


class Replica:
    """A serving replica the router can place work on."""

    def __init__(self, replica_id, engine: InferenceEngine,
                 role: str = "both", reporter=None,
                 watermark_blocks: Optional[int] = None,
                 max_queue: int = 64,
                 clock: Callable[[], float] = time.monotonic,
                 spec_tokens: int = 0,
                 metrics_reporter=None):
        if role not in ROLES:
            raise ValueError(f"role {role!r} not in {ROLES}")
        self.replica_id = replica_id
        self.role = role
        self.clock = clock
        #: Reporter whose summary rides this replica's load beats into
        #: the router's fleet view.  Deliberately separate from
        #: ``reporter``: in-process clusters often share ONE Reporter
        #: across replicas (and with the router), and gossiping a shared
        #: registry would multiply every count at the merge.  Set it
        #: only when the replica owns its registry (the multi-process
        #: service loop does).
        self.metrics_reporter = metrics_reporter
        self._metrics_seq = 0
        self.scheduler = ContinuousBatchingScheduler(
            engine, watermark_blocks=watermark_blocks,
            reporter=reporter, replica=replica_id,
            spec_tokens=spec_tokens,
        )
        self.frontend = ServeFrontend(
            self.scheduler, max_queue=max_queue, clock=clock,
            replica=replica_id,
        )
        self.alive = True
        self.draining = False
        #: shard-group geometry this replica fronts (the leader sets
        #: these when the replica spans a multi-process group); they
        #: ride every load beat so routers and fleet views see group
        #: shape without extra wire traffic.
        self.group_size = 1
        self.pp_stages = 1
        self.lock = threading.Lock()
        self._prefill_jobs: Deque[PrefillJob] = deque()
        #: completed prefills awaiting router placement.
        self.handoffs: Deque[PrefillResult] = deque()

    # -- capabilities --------------------------------------------------
    @property
    def engine(self) -> InferenceEngine:
        return self.scheduler.engine

    @property
    def can_prefill(self) -> bool:
        return self.role in ("prefill", "both")

    @property
    def can_decode(self) -> bool:
        return self.role in ("decode", "both")

    # -- intake (router-side; callers hold self.lock) ------------------
    def enqueue_prefill(self, job: PrefillJob) -> None:
        if not self.can_prefill:
            raise ValueError(
                f"replica {self.replica_id!r} has role {self.role!r}; "
                "it does not prefill"
            )
        self._prefill_jobs.append(job)

    @property
    def pending_prefills(self) -> int:
        return len(self._prefill_jobs)

    # -- load ----------------------------------------------------------
    def load(self, now: Optional[float] = None) -> ReplicaLoad:
        now = self.clock() if now is None else now
        slacks: List[float] = [
            h.timeout_s - (now - h.submitted_at)
            for h in self.frontend._handles.values()
            if not h.done and h.timeout_s is not None
        ]
        st = self.engine.kv.stats()
        metrics_version, metrics = self.metrics_beat()
        return ReplicaLoad(
            replica_id=self.replica_id,
            role=self.role,
            alive=self.alive,
            draining=self.draining,
            free_blocks=st.free_blocks,
            n_blocks=st.n_blocks,
            queue_depth=self.frontend.queue_depth()
            + len(self._prefill_jobs),
            max_queue=self.frontend.max_queue,
            running=len(self.scheduler.running),
            max_batch=self.engine.max_batch,
            min_slack_s=min(slacks) if slacks else None,
            tokens_per_sec=self.frontend.decode_tokens_per_sec(),
            block_size=st.block_size,
            prefix_version=self.engine.kv.index_version,
            prefix_digests=tuple(self.engine.kv.prefix_digests(
                limit=MAX_GOSSIP_DIGESTS
            )),
            max_bucket=self.engine.max_bucket,
            metrics_version=metrics_version,
            metrics=metrics,
            group_size=self.group_size,
            pp_stages=self.pp_stages,
        )

    def metrics_beat(self) -> Tuple[int, Optional[dict]]:
        """Freshly-stamped ``(version, summary)`` metrics payload for a
        load beat — ``(0, None)`` when this replica gossips no metrics
        (no :attr:`metrics_reporter`)."""
        if self.metrics_reporter is None:
            return 0, None
        self._metrics_seq += 1
        return self._metrics_seq, self.metrics_reporter.summary()

    # -- stepping (worker-side; callers hold self.lock) ----------------
    def step(self) -> int:
        """One replica iteration: at most one prefill job, then one
        frontend step.  Returns tokens emitted by the frontend (prefill
        jobs' first tokens are committed by the router at placement, so
        they don't count here)."""
        if self._prefill_jobs and self.can_prefill:
            job = self._prefill_jobs.popleft()
            result = run_prefill_job(self.engine, job,
                                     replica=self.replica_id)
            if result is None:
                # Transient page pressure: retry behind other jobs so
                # one stuck prompt doesn't head-of-line block the rest.
                self._prefill_jobs.append(job)
            else:
                self.handoffs.append(result)
        return self.frontend.step()

    @property
    def has_work(self) -> bool:
        return bool(
            self.scheduler.has_work
            or self._prefill_jobs
            or self.handoffs
        )
