"""Load-aware request router over a fleet of serving replicas.

Placement policy, in the order it is applied:

1. **Admissibility** — alive, not draining, decode-capable, waiting
   queue below capacity, and free pages ≥ the prompt's page need plus
   the replica's admission watermark (so routing never converts
   directly into a preemption storm on arrival).
2. **Deadline slack (SLO routing)** — for requests with a
   ``timeout_s``: replicas whose estimated queue wait (queued requests
   ÷ observed per-replica throughput, when warm) exceeds half the
   request's slack are filtered out, extending the frontend's
   deadline-aware admission across the fleet.  Cold replicas (no
   throughput estimate yet) are never filtered.
3. **Score** — ``2·free_frac − queue_frac − ½·batch_frac``, highest
   wins, ties broken by replica id: prefer pages first (the resource
   that converts to preemptions), then shallow queues, then open batch
   slots.  Deterministic, so tests can pin placements.

Long prompts (≥ ``prefill_threshold``) take the disaggregated path when
a prefill-capable replica is alive: queued as a :class:`PrefillJob`,
first token committed at handoff, pages migrated to the best decode
replica (see :mod:`disagg`).

**Failover** re-queues every live request of a dead replica onto a
survivor, resubmitting ``prompt`` with the already-streamed tokens as
the ``committed`` prefix: admission re-prefills prompt+committed and
sampling continues at the next position with the counter-based RNG, so
the caller-visible stream (``ClusterHandle.tokens``) is bit-identical
to an uninterrupted run — no duplicated, dropped, or reordered tokens.
In-flight prefill jobs and unplaced handoff snapshots from the dead
replica are re-dispatched the same way.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

from ...observability import tracing as _tracing
from .disagg import (
    PrefillJob,
    PrefillResult,
    place_handoff,
)
from .health import HeartbeatMonitor
from .migration import (
    extract_sequence,
    restore_sequence,
)
from .metrics_gossip import MetricsGossip
from .prefix_gossip import PrefixGossip
from .replica import Replica, ReplicaLoad
from ..engine import SamplingParams
from ..frontend import QueueFull
from ..kv_cache import OutOfBlocks, prompt_digests
from ..scheduler import Request


@dataclasses.dataclass
class ClusterHandle:
    """Caller-side view of a routed request.  ``tokens`` is the
    COMMITTED stream — appended exactly once per generated token, in
    order, across any number of migrations/failovers."""

    request_id: int
    prompt: List[int]
    max_new_tokens: int
    sampling: SamplingParams
    stop_token: Optional[int]
    timeout_s: Optional[float]
    submitted_at: float
    on_token: Optional[Callable[[int, int], None]] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    status: str = "routed"  # routed|prefill|finished|failed|timeout
    error: Optional[str] = None
    replica_id: Optional[object] = None
    failovers: int = 0
    #: shed class (0 = most important) — travels with every placement.
    priority: int = 0
    #: accounting identity — travels with every placement so tenant
    #: counters survive migration/failover.
    tenant: Optional[str] = None
    #: opt-in to the SHARED prefix-cache namespace (common system
    #: prompts); default is the tenant's salted namespace.
    shared_prefix: bool = False
    #: times this stream moved replicas via live KV-page migration
    #: (scale-down drains; distinct from failover replays).
    migrations: int = 0
    #: (replica_id, replica-local request id) of the live placement.
    _local: Optional[Tuple[object, int]] = None
    #: trace id when tracing is active (None otherwise).
    trace_id: Optional[str] = None
    #: root span context — the router owns the request's root because
    #: it survives replica failover (see observability/tracing.py).
    _trace_root: Optional[_tracing.SpanCtx] = None

    @property
    def done(self) -> bool:
        return self.status in ("finished", "failed", "timeout")

    def _commit(self, tok: int) -> None:
        self.tokens.append(tok)
        if self.on_token is not None:
            self.on_token(self.request_id, tok)

    def _remaining_timeout(self, now: float) -> Optional[float]:
        if self.timeout_s is None:
            return None
        return self.timeout_s - (now - self.submitted_at)

    @property
    def prefix_namespace(self) -> Optional[str]:
        return None if self.shared_prefix else self.tenant


class ReplicaRouter:
    """Routes requests over ``replicas`` (all sharing model + sampling
    semantics).  ``prefill_threshold``: prompt length at/above which a
    request takes the disaggregated path (None → never).  Driving:
    :meth:`step` (health → place handoffs → step replicas → sync) from
    one thread, or ``drive_replicas=False`` with a
    :class:`ThreadedClusterDriver` stepping replicas concurrently."""

    def __init__(self, replicas: List[Replica],
                 prefill_threshold: Optional[int] = None,
                 reporter=None,
                 health: Optional[HeartbeatMonitor] = None,
                 clock: Callable[[], float] = time.monotonic,
                 straggler_k: float = 4.0):
        if not replicas:
            raise ValueError("a router needs at least one replica")
        ids = [r.replica_id for r in replicas]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids: {ids}")
        self.replicas: Dict[object, Replica] = {
            r.replica_id: r for r in replicas
        }
        self.prefill_threshold = prefill_threshold
        self.reporter = reporter
        self.health = health
        self.clock = clock
        self._handles: Dict[int, ClusterHandle] = {}
        #: replica-local id -> cluster handle, per replica.
        self._by_local: Dict[Tuple[object, int], ClusterHandle] = {}
        self._pending_handoffs: List[Tuple[PrefillResult,
                                           ClusterHandle]] = []
        self._next_gid = 0
        #: flag a replica whose stage-latency median exceeds this
        #: multiple of the fleet median (see tracing.detect_stragglers).
        self.straggler_k = float(straggler_k)
        self._steps = 0
        #: cluster-global prefix index: per-replica digest views folded
        #: from load snapshots at step boundaries (beat cadence), so
        #: placement sees remote prefix hits even when the direct probe
        #: below is unavailable or the view is one beat stale.
        self.gossip = PrefixGossip()
        #: fleet metrics view: latest Reporter snapshot per replica,
        #: folded at the same beat cadence and served via fleet_view().
        self.metrics = MetricsGossip()

    # -- scoring -------------------------------------------------------
    @staticmethod
    def score(load: ReplicaLoad, prefix_frac: float = 0.0) -> float:
        """Higher is better; see the module docstring for the policy.
        ``prefix_frac`` is the fraction of the prompt already resident
        in the replica's prefix cache: a hit skips that share of the
        prefill *and* of the page cost, so it outweighs moderate load
        differences (prefix-affinity routing — the fleet converges on
        sending same-template traffic to the replica that is already
        warm for it)."""
        return (
            2.0 * load.free_frac
            - load.queue_frac
            - 0.5 * load.batch_frac
            + 1.5 * prefix_frac
        )

    def _admissible(self, load: ReplicaLoad, need_blocks: int,
                    watermark: int) -> bool:
        return (
            load.alive
            and not load.draining
            and load.role in ("decode", "both")
            and load.queue_depth < load.max_queue
            and load.free_blocks >= need_blocks + watermark
        )

    def _est_queue_wait_s(self, load: ReplicaLoad) -> Optional[float]:
        if load.tokens_per_sec is None or load.tokens_per_sec <= 0:
            return None
        # queued requests wait for ~a batch-slot's worth of tokens each;
        # use the fleet-standard rough cut: queued ÷ (tokens/s).
        return load.queue_depth / load.tokens_per_sec

    def pick_decode_replica(self, prompt_len: int,
                            timeout_s: Optional[float] = None,
                            now: Optional[float] = None,
                            prompt_tokens: Optional[List[int]] = None,
                            namespace: Optional[str] = None,
                            ) -> Optional[Replica]:
        """The best admissible decode-capable replica for a prompt of
        ``prompt_len`` tokens, or None when nothing admits it.

        When ``prompt_tokens`` is given, each candidate is probed for
        prefix-cache hit potential (``kv.match_prefix`` is read-only),
        the shared pages are discounted from the admission need, and the
        hit fraction feeds the placement score — so duplicate-prefix
        traffic sticks to the replica that already holds those pages.
        The probe is the max of the direct (in-process) index lookup and
        the gossiped digest view, so a hit is seen even when the local
        view lags a beat; staleness is safe because the chosen replica's
        admission re-probes its own index (a phantom hit degrades to a
        full prefill, never a wrong stream — the optimistic need
        discount below shares that property, backed by preemption).
        """
        now = self.clock() if now is None else now
        best, best_key = None, None
        digests_by_bs: Dict[int, List[int]] = {}
        for rep in self.replicas.values():
            load = rep.load(now)
            hit_pages = 0
            if prompt_tokens:
                hit_pages = len(rep.engine.kv.match_prefix(
                    prompt_tokens, namespace=namespace
                ))
                bs = rep.engine.kv.block_size
                if bs not in digests_by_bs:
                    digests_by_bs[bs] = prompt_digests(
                        prompt_tokens, bs, namespace=namespace
                    )
                hit_pages = max(hit_pages, self.gossip.hit_pages(
                    digests_by_bs[bs], rep.replica_id
                ))
            need = rep.engine.kv.blocks_for(prompt_len + 1) - hit_pages
            if not self._admissible(load, need, rep.scheduler.watermark):
                continue
            if timeout_s is not None:
                wait = self._est_queue_wait_s(load)
                if wait is not None and wait > 0.5 * timeout_s:
                    continue
            prefix_frac = 0.0
            if prompt_len > 0:
                prefix_frac = (hit_pages * rep.engine.kv.block_size
                               / prompt_len)
            score = self.score(load, prefix_frac)
            # Warm-ladder affinity: a replica that has already run a
            # context at least this long serves the prompt without a
            # cold trace (its lazily-grown bucket ladders cover it), so
            # nudge long prompts there instead of forcing every replica
            # through its own growth recompile.  A flat bonus — smaller
            # than the prefix-hit term, so actual shared pages still
            # dominate placement.
            if load.max_bucket > 0 and load.max_bucket >= prompt_len:
                score += 0.25
            key = (score, repr(rep.replica_id))
            if best_key is None or key > best_key:
                best, best_key = rep, key
        return best

    def _pick_shed_target(self, priority: int) -> Optional[Replica]:
        """When nothing admits an arrival, the replica whose full queue
        holds the *cheapest* victim strictly below ``priority`` — the
        frontend there sheds it at submission.  None when overload is
        uniform at-or-above this class (the arrival is rejected)."""
        best, best_key = None, None
        for rep in self.replicas.values():
            # rep.alive is a one-way flag: written False exactly once
            # (under rep.lock, in fail_replica / remove_replica) and
            # never resurrected, so the policy pump's bare reads race
            # only benignly — a stale True admits one extra step that
            # fail_replica then unwinds.  Lock-free by design; the
            # monotonicity is pinned by tests/test_hostlint.py.
            if not (rep.alive and not rep.draining  # hostlint: disable=H001
                    and rep.can_decode):
                continue
            if rep.frontend.queue_depth() < rep.frontend.max_queue:
                continue  # not queue-bound: don't shed to jump pages
            victim = rep.frontend.sheddable_class(priority)
            if victim is None:
                continue
            key = (victim, repr(rep.replica_id))
            if best_key is None or key > best_key:
                best, best_key = rep, key
        return best

    def _pick_prefill_replica(self) -> Optional[Replica]:
        best, best_key = None, None
        for rep in self.replicas.values():
            if not (rep.alive and rep.can_prefill and not rep.draining):
                continue
            # Fewest queued prefills, then most free pages.
            key = (-rep.pending_prefills,
                   rep.engine.kv.free_blocks, repr(rep.replica_id))
            if best_key is None or key > best_key:
                best, best_key = rep, key
        return best

    # -- submission ----------------------------------------------------
    def submit(self, prompt, max_new_tokens: int,
               sampling: Optional[SamplingParams] = None,
               stop_token: Optional[int] = None,
               timeout_s: Optional[float] = None,
               on_token: Optional[Callable[[int, int], None]] = None,
               priority: int = 0,
               tenant: Optional[str] = None,
               shared_prefix: bool = False,
               ) -> ClusterHandle:
        """Route one request; raises :class:`QueueFull` (with the
        minimum retry-after hint across replicas) when no replica
        admits it.  ``priority`` is the shed class (0 = most
        important): when every queue is full, an arrival may displace
        a strictly lower-class waiting request instead of being
        rejected (see ``ServeFrontend.submit``).  ``shared_prefix``
        opts a tenanted request into the shared prefix-cache
        namespace (see the frontend's docstring)."""
        gid = self._next_gid
        self._next_gid += 1
        handle = ClusterHandle(
            request_id=gid,
            prompt=list(map(int, prompt)),
            max_new_tokens=int(max_new_tokens),
            sampling=sampling or SamplingParams(),
            stop_token=stop_token,
            timeout_s=timeout_s,
            submitted_at=self.clock(),
            on_token=on_token,
            priority=int(priority),
            tenant=tenant,
            shared_prefix=bool(shared_prefix),
        )
        self._handles[gid] = handle
        tr = _tracing.get_tracer()
        if tr is not None:
            root_attrs = dict(rid=gid, prompt_len=len(handle.prompt),
                              max_new_tokens=handle.max_new_tokens)
            if tenant is not None:
                root_attrs["tenant"] = tenant
            handle._trace_root = tr.begin(
                "request", replica="router", **root_attrs
            )
            handle.trace_id = handle._trace_root.trace_id
        try:
            if (
                self.prefill_threshold is not None
                and len(handle.prompt) >= self.prefill_threshold
                and self._pick_prefill_replica() is not None
            ):
                self._submit_disagg(handle)
            else:
                self._place(handle, committed=[])
        except QueueFull:
            self._close_trace(handle, status="rejected",
                              error="no replica admits this request")
            raise
        return handle

    def _close_trace(self, handle: ClusterHandle,
                     status: Optional[str] = None,
                     error: Optional[str] = None) -> None:
        """End the handle's root span (idempotent, no-op untraced)."""
        root = handle._trace_root
        if root is None:
            return
        handle._trace_root = None
        tr = _tracing.get_tracer()
        if tr is not None:
            tr.end(root, error=error or handle.error,
                   status=status or handle.status,
                   tokens=len(handle.tokens),
                   failovers=handle.failovers)

    def _submit_disagg(self, handle: ClusterHandle) -> None:
        tr = _tracing.get_tracer()
        root = handle._trace_root
        t0 = tr.clock() if (tr is not None and root is not None) else 0.0
        rep = self._pick_prefill_replica()
        job = PrefillJob(
            handle=handle, prompt=list(handle.prompt),
            sampling=handle.sampling, trace=root,
        )
        with rep.lock:
            rep.enqueue_prefill(job)
        if tr is not None and root is not None:
            tr.record_span("placement", root, t0, tr.clock() - t0,
                           replica="router", target=str(rep.replica_id),
                           kind="prefill")
        handle.status = "prefill"
        handle.replica_id = rep.replica_id

    def _place(self, handle: ClusterHandle, committed: List[int]) -> None:
        """Submit (or re-submit, with a committed prefix) onto the best
        decode replica."""
        tr = _tracing.get_tracer()
        root = handle._trace_root
        t0 = tr.clock() if (tr is not None and root is not None) else 0.0
        now = self.clock()
        rep = self.pick_decode_replica(
            len(handle.prompt) + len(committed),
            timeout_s=handle._remaining_timeout(now), now=now,
            prompt_tokens=handle.prompt,
            namespace=handle.prefix_namespace,
        )
        if rep is None:
            rep = self._pick_shed_target(handle.priority)
        if rep is None:
            self._handles.pop(handle.request_id, None)
            if self.reporter is not None:
                # Mirror the frontend's per-class reject counter: a
                # fleet-wide rejection never reaches any frontend.
                self.reporter.count(
                    f"serve/rejected/{handle.priority}", 1)
            hints = [
                r.frontend._retry_after_hint()
                for r in self.replicas.values() if r.alive
            ]
            hints = [h for h in hints if h is not None]
            hint = min(hints) if hints else None
            msg = "no replica admits this request"
            if hint is not None:
                msg += f"; retry after ~{hint:.3f}s"
            raise QueueFull(msg, retry_after_s=hint)
        with rep.lock:
            local = rep.frontend.submit(
                handle.prompt, handle.max_new_tokens,
                sampling=handle.sampling, stop_token=handle.stop_token,
                timeout_s=handle._remaining_timeout(now),
                on_token=lambda _rid, tok: handle._commit(tok),
                committed=committed,
                trace=root,
                priority=handle.priority,
                tenant=handle.tenant,
                shared_prefix=handle.shared_prefix,
            )
        if tr is not None and root is not None:
            tr.record_span("placement", root, t0, tr.clock() - t0,
                           replica="router", target=str(rep.replica_id),
                           committed=len(committed))
        handle.status = "routed"
        handle.replica_id = rep.replica_id
        handle._local = (rep.replica_id, local.request_id)
        self._by_local[handle._local] = handle

    # -- handoff placement ---------------------------------------------
    def _collect_handoffs(self) -> None:
        for rep in self.replicas.values():
            if not rep.alive:
                continue
            with rep.lock:
                results = []
                while rep.handoffs:
                    results.append(rep.handoffs.popleft())
            for res in results:
                handle: ClusterHandle = res.job.handle
                if res.error is not None:
                    handle.status = "failed"
                    handle.error = res.error
                    continue
                self._pending_handoffs.append((res, handle))

    def _place_handoffs(self) -> None:
        still = []
        for res, handle in self._pending_handoffs:
            if handle.done:
                continue  # timed out while pending
            placed = self._try_place_handoff(res, handle)
            if not placed:
                still.append((res, handle))
        self._pending_handoffs = still

    def _try_place_handoff(self, res: PrefillResult,
                           handle: ClusterHandle) -> bool:
        tr = _tracing.get_tracer()
        root = handle._trace_root
        if not handle.tokens:
            # First token was sampled by the prefill replica; commit it
            # exactly once, at handoff (stream order is preserved: the
            # request isn't decoding anywhere yet).
            handle._commit(res.first_token)
            if tr is not None and root is not None:
                tr.token(root)
            if (
                len(handle.tokens) >= handle.max_new_tokens
                or res.first_token == handle.stop_token
            ):
                handle.status = "finished"
                return True
        now = self.clock()
        rep = self.pick_decode_replica(
            len(handle.prompt) + len(handle.tokens),
            timeout_s=handle._remaining_timeout(now), now=now,
            prompt_tokens=handle.prompt,
            namespace=handle.prefix_namespace,
        )
        if rep is None:
            return False
        req = Request(
            request_id=None,
            prompt=list(handle.prompt),
            max_new_tokens=handle.max_new_tokens,
            sampling=handle.sampling,
            stop_token=handle.stop_token,
            on_token=lambda _rid, tok: handle._commit(tok),
            trace=root,
            tenant=handle.tenant,
            shared_prefix=handle.shared_prefix,
        )
        req.generated = list(handle.tokens)
        with rep.lock:
            local = place_handoff(
                rep, res, req,
                timeout_s=handle._remaining_timeout(now),
            )
        if local is None:
            return False
        handle.status = "routed"
        handle.replica_id = rep.replica_id
        handle._local = (rep.replica_id, local.request_id)
        self._by_local[handle._local] = handle
        return True

    # -- failover ------------------------------------------------------
    def fail_replica(self, replica_id, reason: str = "unknown") -> int:
        """Declare ``replica_id`` dead and re-queue its live work onto
        survivors.  Returns how many requests were re-queued.  Safe to
        call twice (second call finds nothing live there)."""
        rep = self.replicas.get(replica_id)
        if rep is None:
            return 0
        # Take the victim's lock FIRST: an in-flight step (threaded
        # driving) may still commit tokens to handles placed there.
        # Once we hold the lock the step has finished, its commits have
        # landed, and ``alive=False`` stops any further stepping — the
        # committed prefix we replay below is final, so survivors never
        # regenerate a token the victim already streamed.
        with rep.lock:
            rep.alive = False
            jobs = list(rep._prefill_jobs)
            rep._prefill_jobs.clear()
            results = list(rep.handoffs)
            rep.handoffs.clear()
        if self.health is not None:
            self.health.mark_dead(replica_id)
        self.gossip.forget(replica_id)
        self.metrics.forget(replica_id)
        if self.reporter is not None:
            # stale-series fix: the victim's last serving/*/replica/<id>
            # gauges must not outlive it on the router's own registry
            self.reporter.forget_replica(replica_id)
        moved = 0
        # 1. Streaming requests placed on the dead replica: re-place
        #    with their committed prefix.
        for (rid, lid), handle in list(self._by_local.items()):
            if rid != replica_id or handle.done:
                continue
            del self._by_local[(rid, lid)]
            local = rep.frontend._handles.get(lid)
            if local is not None and local.done:
                # Completed on the victim after the last sync (threaded
                # driving): its stream is whole; re-placing it would
                # sample one token past its end.
                handle.status, handle.error = local.status, local.error
                handle._local = None
                continue
            handle.failovers += 1
            self._requeue(handle, reason)
            moved += 1
        # 2. Prefill jobs queued (not yet run) on it: re-dispatch.
        for job in jobs:
            handle = job.handle
            if not handle.done:
                handle.failovers += 1
                self._requeue(handle, reason)
                moved += 1
        # 3. Completed handoff snapshots it produced remain valid (host
        #    memory, device-independent) — keep them pending.
        for res in results:
            if res.error is None and not res.job.handle.done:
                self._pending_handoffs.append((res, res.job.handle))
        return moved

    def _requeue(self, handle: ClusterHandle, reason: str) -> None:
        tr = _tracing.get_tracer()
        if tr is not None and handle._trace_root is not None:
            tr.event("failover", handle._trace_root, replica="router",
                     reason=reason, from_replica=str(handle.replica_id),
                     committed=len(handle.tokens))
        try:
            self._place(handle, committed=list(handle.tokens))
        except QueueFull as e:
            handle.status = "failed"
            handle.error = (
                f"replica {handle.replica_id!r} died ({reason}) and no "
                f"survivor admits the request: {e}"
            )
        else:
            self._handles[handle.request_id] = handle

    # -- driving -------------------------------------------------------
    def step(self, drive_replicas: bool = True) -> int:
        """One router iteration.  Returns tokens emitted fleet-wide
        (only meaningful when ``drive_replicas``)."""
        now = self.clock()
        self._steps += 1
        if self.health is not None:
            for rid in self.health.check(now):
                self.fail_replica(rid, reason="missed heartbeats")
        emitted = 0
        if drive_replicas:
            for rep in self.replicas.values():
                if not rep.alive:
                    continue
                with rep.lock:
                    emitted += rep.step()
                if self.health is not None:
                    self.health.beat(rep.replica_id, now)
        # Anti-entropy beat: fold every live replica's digest snapshot
        # into the gossip view (in-process the "wire" is a method call,
        # but the freshness semantics match the service loop: the view
        # advances at step boundaries, placement reads it in between).
        for rep in self.replicas.values():
            if rep.alive:
                kv = rep.engine.kv
                self.gossip.observe(
                    rep.replica_id, kv.index_version,
                    kv.prefix_digests(),
                )
                mv, ms = rep.metrics_beat()
                self.metrics.observe(rep.replica_id, mv, ms)
        self._collect_handoffs()
        self._place_handoffs()
        self._sync(now)
        if self.reporter is not None:
            self.reporter.gauge(
                "serving/cluster/replicas_alive",
                sum(r.alive for r in self.replicas.values()),
            )
            self.reporter.gauge(
                "serving/cluster/pending_handoffs",
                len(self._pending_handoffs),
            )
            self._straggler_gauges()
        return emitted

    def _straggler_gauges(self) -> None:
        """Periodically compare per-replica stage medians against the
        fleet and publish flag + lag-ratio gauges (tools.obs splits the
        ``/replica/<id>`` suffix into a Prometheus label)."""
        tr = _tracing.get_tracer()
        if tr is None or self._steps % 32 != 0:
            return
        flagged = _tracing.detect_stragglers(
            tr.stage_stats(), k=self.straggler_k
        )
        for rid in self.replicas:
            f = flagged.get(rid) or flagged.get(str(rid))
            self.reporter.gauge(
                f"trace/straggler/replica/{rid}", 1.0 if f else 0.0
            )
            if f:
                self.reporter.gauge(
                    f"trace/stage_lag/replica/{rid}", max(f.values())
                )

    def _sync(self, now: float) -> None:
        """Propagate replica-local completion/failure/timeouts to
        cluster handles, and expire cluster-level deadlines for work not
        currently placed anywhere (pending handoffs, prefill queue)."""
        for handle in self._handles.values():
            if handle.done:
                self._close_trace(handle)
                continue
            if handle._local is not None:
                rid, lid = handle._local
                rep = self.replicas.get(rid)
                if rep is None or not rep.alive:
                    continue  # failover path owns it
                local = rep.frontend._handles.get(lid)
                if local is None or not local.done:
                    continue
                handle.status = local.status
                handle.error = local.error
                self._by_local.pop(handle._local, None)
                handle._local = None
            elif (
                handle.timeout_s is not None
                and now - handle.submitted_at > handle.timeout_s
            ):
                handle.status = "timeout"
                handle.error = "deadline exceeded"
            if handle.done:
                self._close_trace(handle)

    @property
    def has_work(self) -> bool:
        return (
            any(not h.done for h in self._handles.values())
            or bool(self._pending_handoffs)
        )

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        steps = 0
        while self.has_work:
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"router did not drain within {max_steps} steps"
                )
            self.step()

    def result(self, handle: ClusterHandle,
               max_steps: int = 100_000) -> List[int]:
        """Drive until ``handle`` completes; returns its tokens.
        Raises on failure/timeout (mirrors ``ServeFrontend.result``)."""
        steps = 0
        while not handle.done:
            steps += 1
            if steps > max_steps:
                raise RuntimeError("request did not complete")
            self.step()
        if handle.status == "timeout":
            raise TimeoutError(
                f"request {handle.request_id} exceeded its deadline"
            )
        if handle.status == "failed":
            raise RuntimeError(
                f"request {handle.request_id} failed: {handle.error}"
            )
        return list(handle.tokens)

    # -- membership (autoscaling) --------------------------------------
    def add_replica(self, replica: Replica) -> Replica:
        """Join a freshly spawned replica to the fleet (scale-up).  It
        becomes routable immediately; a :class:`ThreadedClusterDriver`
        picks it up on its next ``ensure_threads()``."""
        if replica.replica_id in self.replicas:
            raise ValueError(
                f"replica id {replica.replica_id!r} already in fleet"
            )
        self.replicas[replica.replica_id] = replica
        if self.health is not None:
            self.health.beat(replica.replica_id)
        if self.reporter is not None:
            self.reporter.count("serving/cluster/replicas_added", 1)
        return replica

    # -- drain / scale-down --------------------------------------------
    def drain(self, replica_id) -> None:
        """Stop routing NEW work to ``replica_id``; its in-flight
        streams finish normally.  The graceful half of scale-down."""
        self.replicas[replica_id].draining = True

    def migrate_out(self, replica_id) -> int:
        """Move every live stream off ``replica_id`` (typically
        draining) onto survivors, waiting requests by resubmission and
        RUNNING ones by live KV-page migration — the committed stream
        never stalls past one extract/restore, no token is dropped or
        regenerated.  Returns how many streams moved.  A stream with no
        viable target stays put (it finishes where it is; retirement
        just waits).
        """
        src = self.replicas.get(replica_id)
        if src is None:
            return 0
        moved = 0
        now = self.clock()
        for (rid, lid), handle in list(self._by_local.items()):
            if rid != replica_id or handle.done:
                continue
            with src.lock:
                local = src.frontend._handles.get(lid)
                req = local._request if local is not None else None
                if req is None or req.done:
                    continue
                sched = src.scheduler
                if req in sched.waiting:
                    # Not admitted yet: no device state, nothing to
                    # migrate — pull it out and re-place it whole.
                    sched.waiting.remove(req)
                    src.frontend._handles.pop(lid, None)
                    snap, target = None, None
                elif req in sched.running:
                    target = self._pick_adopt_target(req, exclude=rid)
                    if target is None:
                        continue
                    # Between iterations (we hold src.lock) the pages
                    # cover exactly len(context)-1 positions — the last
                    # generated token is the next step's input.  That is
                    # precisely the adoption contract on the other side.
                    sched.running.remove(req)
                    snap = extract_sequence(
                        src.engine, lid, context=req.context,
                        prompt_len=len(req.prompt),
                    )
                    src.engine.kv.free(lid)
                    src.frontend._handles.pop(lid, None)
                else:
                    continue
            del self._by_local[(rid, lid)]
            handle._local = None
            handle.migrations += 1
            if snap is None:
                try:
                    self._place(handle, committed=list(handle.tokens))
                    self._handles[handle.request_id] = handle
                except QueueFull:
                    # Survivors refused after all — give the slot we
                    # just vacated back to src; retirement waits.
                    self._return_to(src, handle)
                    continue
            else:
                if not self._adopt_on(target, src, handle, snap, req,
                                      now):
                    continue
            if self.reporter is not None and not handle.done:
                self.reporter.count("serving/cluster/migrations", 1)
            moved += 1
        return moved

    def _return_to(self, src: Replica, handle: ClusterHandle) -> None:
        """Re-home a stream onto the replica it was being migrated off
        (committed-prefix replay) — the no-harm fallback when no
        survivor can take it.  Bypasses routing: ``src`` may be
        draining, but it still owes its own streams."""
        try:
            with src.lock:
                local = src.frontend.submit(
                    handle.prompt, handle.max_new_tokens,
                    sampling=handle.sampling,
                    stop_token=handle.stop_token,
                    timeout_s=handle._remaining_timeout(self.clock()),
                    on_token=lambda _rid, tok: handle._commit(tok),
                    committed=list(handle.tokens),
                    trace=handle._trace_root,
                    priority=handle.priority,
                    tenant=handle.tenant,
                    shared_prefix=handle.shared_prefix,
                )
        except QueueFull as e:
            handle.status = "failed"
            handle.error = f"drain migration found no placement: {e}"
            return
        handle.status = "routed"
        handle.replica_id = src.replica_id
        handle._local = (src.replica_id, local.request_id)
        self._by_local[handle._local] = handle
        self._handles[handle.request_id] = handle

    def _pick_adopt_target(self, req: Request,
                           exclude=None) -> Optional[Replica]:
        """Best survivor that can adopt ``req``'s live pages RIGHT NOW:
        an open batch slot and enough free pages for the sequence (the
        watermark held back, as at admission)."""
        best, best_key = None, None
        for rep in self.replicas.values():
            if rep.replica_id == exclude:
                continue
            load = rep.load()
            if not (load.alive and not load.draining
                    and rep.can_decode
                    and load.running < load.max_batch):
                continue
            need = rep.engine.kv.blocks_for(len(req.context))
            if load.free_blocks < need + rep.scheduler.watermark:
                continue
            key = (self.score(load), repr(rep.replica_id))
            if best_key is None or key > best_key:
                best, best_key = rep, key
        return best

    def _adopt_on(self, target: Replica, src: Replica,
                  handle: ClusterHandle, snap, req: Request,
                  now: float) -> bool:
        """Restore ``snap`` on ``target`` and adopt the stream there.
        On restore failure (lost a page race to target's own
        admissions) falls back to committed-prefix replay — slower, but
        the stream stays bit-exact either way."""
        adopted = False
        with target.lock:
            rid2 = target.frontend.reserve_id()
            try:
                restore_sequence(target.engine, snap, rid2)
                req2 = Request(
                    request_id=rid2,
                    prompt=list(handle.prompt),
                    max_new_tokens=handle.max_new_tokens,
                    sampling=handle.sampling,
                    stop_token=handle.stop_token,
                    on_token=lambda _rid, tok: handle._commit(tok),
                    trace=handle._trace_root,
                    priority=handle.priority,
                    tenant=handle.tenant,
                    shared_prefix=handle.shared_prefix,
                )
                req2.generated = list(req.generated)
                target.frontend.adopt(
                    req2, timeout_s=handle._remaining_timeout(now)
                )
                adopted = True
            except OutOfBlocks:
                if rid2 in target.engine.kv:
                    target.engine.kv.free(rid2)
        if not adopted:
            try:
                self._place(handle, committed=list(handle.tokens))
                self._handles[handle.request_id] = handle
            except QueueFull:
                self._return_to(src, handle)
                return False
            return True
        handle.status = "routed"
        handle.replica_id = target.replica_id
        handle._local = (target.replica_id, rid2)
        self._by_local[handle._local] = handle
        return True

    def retire_replica(self, replica_id) -> bool:
        """Remove a DRAINED replica from the fleet (scale-down's final
        step).  Refuses — returns False — while any live stream, queued
        prefill, or unplaced handoff still lives there, so calling it
        in a loop after :meth:`drain` + :meth:`migrate_out` retires
        with zero dropped streams.  The replica's driver thread exits
        on the ``alive`` flip."""
        rep = self.replicas.get(replica_id)
        if rep is None:
            return True
        busy = any(
            rid == replica_id and not h.done
            for (rid, _), h in self._by_local.items()
        )
        with rep.lock:
            if busy or rep.has_work:
                return False
            rep.alive = False
        del self.replicas[replica_id]
        self.gossip.forget(replica_id)
        self.metrics.forget(replica_id)
        if self.health is not None:
            self.health.forget(replica_id)
        if self.reporter is not None:
            self.reporter.forget_replica(replica_id)
            self.reporter.count("serving/cluster/replicas_retired", 1)
        return True

    def loads(self, now: Optional[float] = None) -> List[ReplicaLoad]:
        now = self.clock() if now is None else now
        return [r.load(now) for r in self.replicas.values()]

    def fleet_view(self) -> dict:
        """The merged fleet summary — the router's own Reporter plus the
        latest gossiped snapshot of every live replica.  This is what a
        router-attached :class:`MetricsExporter` serves: one scrape
        covers the fleet, and a forgotten replica's series are already
        gone."""
        extra = ([self.reporter.summary()]
                 if self.reporter is not None else [])
        return self.metrics.fleet_view(extra=extra)
