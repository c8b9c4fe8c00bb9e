"""Multi-process serving tier over the host object plane — port of
``chainermn_tpu/serving/cluster/service.py``; its wire protocol is the
reference's.

One process per role: global rank 0 runs :func:`run_router`, every
other rank :func:`run_replica`.  All control traffic rides ONE
:class:`ObjectPlane` (namespace ``"serve"``); bulk KV snapshots ride
replica-to-replica p2p on the same plane (the typed SocketPlane path).

Wire protocol (all p2p, per-edge ordered by the plane's seq matching):

=====================  =============================================
router → replica (tag CMD)
---------------------------------------------------------------------
``{"op": "submit"}``    place a request: gid, prompt, max_new_tokens,
                        sampling, stop_token, committed (failover
                        replay prefix), timeout_s, trace (root span
                        context or None — replica stage spans parent
                        to it; see observability/tracing.py)
``{"op": "prefill"}``   disaggregated prompt: gid, prompt, sampling,
                        trace
``{"op": "send_snapshot"}``  ship gid's finished prefill snapshot to
                        global rank ``dest`` (tag SNAP)
``{"op": "recv_snapshot"}``  receive gid's snapshot from global rank
                        ``source`` and adopt the request
``{"op": "stop"}``      drain nothing, exit the loop
---------------------------------------------------------------------
replica → router (tag EVT) — a LIST of events per loop iteration
(sent at least every ``heartbeat_s`` even when empty: the batch IS the
heartbeat)
---------------------------------------------------------------------
``("tok", gid, token)``           one streamed token, in order
``("done", gid, status, error)``  request left the replica
``("reject", gid, retry_after)``  queue full at submit (router
                                  re-places elsewhere)
``("handoff_ready", gid, tok)``   prefill finished; first token
``("handoff_failed", gid, err)``  prefill/adopt failed terminally
``("adopted", gid)``              snapshot restored + request adopted
``("load", load_dict)``           ReplicaLoad.as_dict() snapshot
=====================  =============================================

Death handling: the router treats a ``PeerGone`` from any recv/send on
a replica's edge — or ``miss_after_s`` without an event batch — as that
replica's death, and re-places its live requests on survivors with
their committed token prefix (bit-exact resume, same as the in-process
router).  Replicas symmetrically exit if the router's edge dies.

Shard groups (serving/cluster/shard_group.py): with ``group_size`` /
``pp_stages`` > 1 the replica ranks partition into consecutive groups
— one leader (it alone runs this module's replica loop and owns all
CMD/EVT/SNAP traffic; group id = leader rank) plus followers running
the lockstep replay loop over the intra-group channel (tag GRP=3 on
the same plane).  The router addresses leaders only; any shard's death
collapses the whole group onto the existing failover path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

from ...communicators.kvtransport import ObjectPlane, PeerGone
from ...observability import tracing as _tracing
from ...observability.exporter import MetricsExporter
from ...observability.reporter import Reporter
from ..engine import SamplingParams
from ..frontend import QueueFull
from ..kv_cache import prompt_digests
from .health import HeartbeatMonitor
from .metrics_gossip import MetricsGossip
from .prefix_gossip import PrefixGossip
from .replica import Replica, ReplicaLoad
from .router import ReplicaRouter

CMD = 1
EVT = 2
SNAP = 7

#: recv poll slice for the event loops (ms) — short enough to interleave
#: stepping with message handling, long enough not to spin.
POLL_MS = 2


def _mk_plane(rank: int, size: int) -> ObjectPlane:
    return ObjectPlane("serve", rank, size, site="serving-cluster")


# ---------------------------------------------------------------------
# replica side
# ---------------------------------------------------------------------

def run_replica(rank: int, size: int, engine_factory,
                role: str = "both",
                max_queue: int = 64,
                watermark_blocks: Optional[int] = None,
                heartbeat_s: float = 0.2,
                kill_after_tokens: Optional[int] = None,
                plane: Optional[ObjectPlane] = None,
                flight_path: Optional[str] = None,
                spec_tokens: int = 0,
                metrics_port: Optional[int] = None,
                group=None,
                kill_after_ops: Optional[int] = None) -> dict:
    """Serve as replica ``rank`` until the router says stop (or the
    router's edge dies).  ``engine_factory()`` builds the
    InferenceEngine (model + params + config) — construction is the
    caller's business, the loop is ours.  ``kill_after_tokens`` is the
    soak-test hook: SIGKILL THIS process after streaming that many
    tokens (mid-stream, no cleanup — simulating a crashed host).

    ``group`` — a :class:`~chainermn_tpu_torch.serving.cluster.
    shard_group.GroupSpec` when this rank is part of a multi-process
    shard group.  The leader rank runs the normal replica loop with the
    group's mirror fan-out attached; any OTHER rank of the group
    dispatches straight to the follower replay loop (no router edge at
    all).
    ``kill_after_ops`` is the follower-side soak hook: SIGKILL a
    follower after replaying that many mirrored steps."""
    if group is not None and rank != group.leader:
        from .shard_group import run_follower

        return run_follower(
            rank, group, engine_factory, plane or _mk_plane(rank, size),
            kill_after_ops=kill_after_ops,
        )
    return _run_replica_outer(
        rank, size, engine_factory, role, max_queue, watermark_blocks,
        heartbeat_s, kill_after_tokens, plane, flight_path, spec_tokens,
        metrics_port, group,
    )


def _run_replica_outer(rank, size, engine_factory, role, max_queue,
                       watermark_blocks, heartbeat_s,
                       kill_after_tokens, plane, flight_path,
                       spec_tokens, metrics_port, group) -> dict:
    """Tracer/exporter scaffolding around the leader's serve loop.

    ``flight_path`` — install a tracer backed by a crash-surviving
    :class:`FlightRecorder` at that path for the duration (no-op when a
    tracer is already installed; the already-installed one wins).

    ``metrics_port`` — serve this replica's Reporter at
    ``http://127.0.0.1:<port>/metrics`` for the duration (0 = ephemeral
    port).  The same Reporter's summary always rides the load beats
    into the router's fleet view, exporter or not."""
    tr = None
    if flight_path is not None and _tracing.get_tracer() is None:
        tr = _tracing.Tracer(
            flight=_tracing.FlightRecorder(flight_path, replica=rank),
            replica=rank,
        )
        _tracing.install(tr)
    reporter = Reporter()
    exporter = None
    if metrics_port is not None:
        exporter = MetricsExporter(reporter, port=metrics_port)
        exporter.start()
    try:
        return _run_replica_inner(
            rank, size, engine_factory, role, max_queue,
            watermark_blocks, heartbeat_s, kill_after_tokens, plane,
            spec_tokens, reporter, group,
        )
    finally:
        if exporter is not None:
            exporter.stop()
        if tr is not None:
            _tracing.uninstall(tr)
            tr.close()


def _run_replica_inner(rank, size, engine_factory, role, max_queue,
                       watermark_blocks, heartbeat_s,
                       kill_after_tokens, plane, spec_tokens=0,
                       reporter=None, group=None) -> dict:
    import os
    import signal

    plane = plane or _mk_plane(rank, size)
    # Announce liveness BEFORE paying engine construction: building and
    # moving the module to the card can dwarf the router's heartbeat
    # budget, and an empty event batch is a valid beat.
    try:
        plane.send([], 0, tag=EVT)
    except PeerGone:
        return {"streamed": 0, "reason": "router gone"}
    leader = None
    if group is not None and group.followers:
        from .shard_group import GroupLeader

        leader = GroupLeader(plane, group)
    rep = Replica(
        rank, engine_factory(), role=role,
        watermark_blocks=watermark_blocks, max_queue=max_queue,
        spec_tokens=spec_tokens,
        # This process OWNS its registry, so it both publishes into it
        # and gossips it to the router on every load beat.
        reporter=reporter, metrics_reporter=reporter,
    )
    if leader is not None:
        # Every device-mutating engine step now fans out to the
        # follower shards before running locally; a dead follower
        # surfaces as PeerGone from the step itself or from poll().
        leader.attach(rep.engine)
        rep.group_size = group.group_size
        rep.pp_stages = group.pp_stages
    outbox: List[tuple] = []
    gid_of_local: Dict[int, int] = {}
    snapshots: Dict[int, object] = {}  # gid -> finished PrefillResult
    reported_done: set = set()
    streamed = 0
    last_evt = 0.0

    def on_token_for(gid: int):
        def cb(_local_rid, tok):
            nonlocal streamed
            outbox.append(("tok", gid, int(tok)))
            streamed += 1
        return cb

    def handle_cmd(msg: dict) -> bool:
        gid = msg.get("gid")
        if msg["op"] == "stop":
            return False
        tr = _tracing.get_tracer()
        ctx = _tracing.SpanCtx.from_wire(msg.get("trace"))
        traced = tr is not None and ctx is not None
        if msg["op"] == "submit":
            sp = SamplingParams(**msg["sampling"])
            try:
                h = rep.frontend.submit(
                    msg["prompt"], msg["max_new_tokens"], sampling=sp,
                    stop_token=msg["stop_token"],
                    timeout_s=msg["timeout_s"],
                    on_token=on_token_for(gid),
                    committed=msg["committed"],
                    trace=ctx,
                    # .get(): wire compat with routers predating the
                    # tenant accounting / prefix-isolation fields.
                    tenant=msg.get("tenant"),
                    shared_prefix=bool(msg.get("shared_prefix", False)),
                )
            except QueueFull as e:
                outbox.append(("reject", gid, e.retry_after_s))
            else:
                gid_of_local[h.request_id] = gid
        elif msg["op"] == "prefill":
            from .disagg import PrefillJob

            rep.enqueue_prefill(PrefillJob(
                handle=gid, prompt=msg["prompt"],
                sampling=SamplingParams(**msg["sampling"]),
                trace=ctx,
            ))
        elif msg["op"] == "send_snapshot":
            from .migration import send_snapshot

            res = snapshots.pop(gid)
            dest = msg["dest"]
            t0 = tr.clock() if traced else 0.0
            try:
                send_snapshot(
                    plane, plane.members.index(dest), res.snapshot,
                    tag=SNAP,
                )
            except PeerGone:
                if traced:
                    tr.record_span("migrate_send", ctx, t0,
                                   tr.clock() - t0, error=True,
                                   dest=dest)
                # the router will see dest's death and requeue
            else:
                if traced:
                    tr.record_span("migrate_send", ctx, t0,
                                   tr.clock() - t0, dest=dest,
                                   tokens=len(res.snapshot.context))
        elif msg["op"] == "recv_snapshot":
            from ..scheduler import Request
            from .migration import recv_snapshot, restore_sequence

            t0 = tr.clock() if traced else 0.0
            try:
                snap = recv_snapshot(
                    plane, plane.members.index(msg["source"]),
                    tag=SNAP, timeout_ms=30_000,
                )
                rid = rep.frontend.reserve_id()
                restore_sequence(rep.engine, snap, rid)
                req = Request(
                    request_id=rid,
                    prompt=list(msg["prompt"]),
                    max_new_tokens=msg["max_new_tokens"],
                    sampling=SamplingParams(**msg["sampling"]),
                    stop_token=msg["stop_token"],
                    on_token=on_token_for(gid),
                    trace=ctx,
                    tenant=msg.get("tenant"),
                    shared_prefix=bool(msg.get("shared_prefix", False)),
                )
                req.generated = list(msg["committed"])
                rep.frontend.adopt(req, timeout_s=msg["timeout_s"])
            except (PeerGone, TimeoutError, ValueError) as e:
                if traced:
                    tr.record_span("migrate_recv", ctx, t0,
                                   tr.clock() - t0, error=True,
                                   source=msg["source"])
                outbox.append(("handoff_failed", gid, str(e)))
            else:
                if traced:
                    tr.record_span("migrate_recv", ctx, t0,
                                   tr.clock() - t0,
                                   source=msg["source"],
                                   tokens=len(req.context))
                gid_of_local[rid] = gid
                outbox.append(("adopted", gid))
        return True

    running = True
    while running:
        # Drain pending commands (tiny poll: stepping must not starve).
        while True:
            try:
                msg = plane.recv(0, tag=CMD, timeout_ms=POLL_MS)
            except TimeoutError:
                break
            except PeerGone:
                return {"streamed": streamed, "reason": "router gone"}
            if not handle_cmd(msg):
                running = False
                break
        try:
            rep.step()
            if leader is not None:
                leader.poll()
        except PeerGone:
            # A follower shard died: the mirror fan-out (inside
            # rep.step()) or the beat poll hit its dead edge.  Any-shard
            # death fails the WHOLE group — exit the serve loop so the
            # router sees PeerGone on this leader's edges within one
            # beat and re-places every live stream on a survivor group.
            return {"streamed": streamed, "reason": "follower gone"}
        # Finished prefills: announce, park the snapshot for migration.
        while rep.handoffs:
            res = rep.handoffs.popleft()
            gid = res.job.handle
            if res.error is not None:
                outbox.append(("handoff_failed", gid, res.error))
            else:
                snapshots[gid] = res
                outbox.append(
                    ("handoff_ready", gid, int(res.first_token))
                )
        # Completions.
        for h in list(rep.frontend._handles.values()):
            gid = gid_of_local.get(h.request_id)
            if gid is None or gid in reported_done:
                continue
            if h.done:
                reported_done.add(gid)
                outbox.append(("done", gid, h.status, h.error))
        if (
            kill_after_tokens is not None
            and streamed >= kill_after_tokens
        ):
            # Crash simulation: die NOW, mid-stream, with tokens queued
            # and sequences live.  No flush, no cleanup.
            os.kill(os.getpid(), signal.SIGKILL)
        now = time.monotonic()
        if outbox or now - last_evt > heartbeat_s:
            batch = outbox + [("load", rep.load().as_dict())]
            outbox = []
            try:
                plane.send(batch, 0, tag=EVT)
            except PeerGone:
                return {"streamed": streamed, "reason": "router gone"}
            last_evt = now
        if not rep.has_work:
            time.sleep(0.002)
    if leader is not None:
        leader.stop()
    try:
        plane.send([("load", rep.load().as_dict())], 0, tag=EVT)
    except PeerGone:
        pass
    # A clean stop must leave the page pool coherent — failovers and
    # adoptions this replica absorbed included.
    rep.engine.kv.assert_consistent()
    return {"streamed": streamed, "reason": "stopped"}


# ---------------------------------------------------------------------
# router side
# ---------------------------------------------------------------------

class _RemoteRequest:
    """Router-side record of one request's life in the remote fleet."""

    def __init__(self, gid: int, spec: dict):
        self.gid = gid
        self.spec = spec
        self.tokens: List[int] = []
        self.status = "pending"
        self.error: Optional[str] = None
        self.replica: Optional[int] = None  # subgroup rank
        self.failovers = 0
        #: router-side arrival time of each token (seconds since the
        #: traffic's release).
        self.token_times: List[float] = []
        #: root span context (router-owned) when tracing is active.
        self.trace = None

    @property
    def done(self) -> bool:
        return self.status in ("finished", "failed", "timeout")


def run_router(size: int, requests: List[dict],
               prefill_threshold: Optional[int] = None,
               roles: Optional[Dict[int, str]] = None,
               miss_after_s: float = 3.0,
               timeout_s: float = 300.0,
               reporter=None,
               plane: Optional[ObjectPlane] = None,
               flight_path: Optional[str] = None,
               slo=None,
               metrics_port: Optional[int] = None,
               metrics_port_file: Optional[str] = None,
               group_size: int = 1,
               pp_stages: int = 1,
               wait_ready: bool = False,
               stats: Optional[dict] = None) -> Dict[int, dict]:
    """Drive ``requests`` (dicts: prompt, max_new_tokens, optional
    sampling/stop_token/timeout_s/tenant/shared_prefix) to completion
    over the replica processes at subgroup ranks ``1..size-1``.
    Returns ``{gid: {"tokens": [...], "status": ..., "error": ...,
    "failovers": n, "replica": r, "token_times": [...]}}`` with token
    streams exactly as a single sequential engine would produce them;
    ``token_times`` are the router's arrival times of each token, in
    seconds since the traffic was released.

    ``wait_ready`` (a port addition) — hold every request until each
    replica (group leader) has sent a load beat, i.e. built its engine,
    or died: the traffic then meets a warm fleet and placement sees real
    loads.  ``stats`` (a dict) receives ``ready_s`` (router start to the
    traffic's release) and ``serve_wall_s`` (release to the last
    request's end).

    ``group_size`` / ``pp_stages`` — shard-group geometry: the replica
    ranks partition into consecutive groups of ``group_size ×
    pp_stages`` processes (shard_group.plan_groups) and the router
    addresses ONLY the leaders; 1×1 is the historical one-process
    fleet.  The launcher must start the follower ranks with the
    matching ``group=`` spec on :func:`run_replica`.

    ``flight_path`` — install a FlightRecorder-backed tracer for the
    duration; the router owns every request's ROOT span (it survives
    replica failover), replicas contribute stage spans via the
    ``trace`` field on CMD frames.

    ``slo`` — an :class:`~chainermn_tpu_torch.observability.tracing.
    SLOConfig`;
    installs a tracer (even without ``flight_path``) wired to
    ``reporter`` so ``slo/burn_rate/<stage>`` gauges accumulate on the
    router, where stage spans from every replica converge.

    ``metrics_port`` — serve the merged FLEET view (the router's own
    Reporter plus the heartbeat-gossiped snapshot of every live
    replica) at ``http://127.0.0.1:<port>/metrics``; 0 binds an
    ephemeral port, and ``metrics_port_file`` (written once, atomically
    enough for a poll loop: temp file + rename) tells an external
    scraper which port was bound."""
    tr = None
    if (flight_path is not None or slo is not None) \
            and _tracing.get_tracer() is None:
        flight = None
        if flight_path is not None:
            flight = _tracing.FlightRecorder(flight_path,
                                             replica="router")
        tr = _tracing.Tracer(
            flight=flight, replica="router",
            reporter=reporter, slo=slo,
        )
        _tracing.install(tr)
    if metrics_port is None and metrics_port_file is not None:
        metrics_port = 0
    metrics = MetricsGossip()
    exporter = None
    if metrics_port is not None:
        if reporter is None:
            reporter = Reporter()  # the fleet view needs a registry

        def fleet_view(reporter=reporter, metrics=metrics) -> dict:
            return metrics.fleet_view(extra=[reporter.summary()])

        exporter = MetricsExporter(fleet_view, port=metrics_port)
        bound = exporter.start()
        if metrics_port_file is not None:
            import os
            tmp = f"{metrics_port_file}.tmp"
            with open(tmp, "w") as f:
                f.write(str(bound))
            os.replace(tmp, metrics_port_file)
    try:
        return _run_router_inner(
            size, requests, prefill_threshold, roles, miss_after_s,
            timeout_s, reporter, plane, metrics, group_size, pp_stages,
            wait_ready, stats,
        )
    finally:
        if exporter is not None:
            exporter.stop()
        if tr is not None:
            _tracing.uninstall(tr)
            tr.close()


def _run_router_inner(size, requests, prefill_threshold, roles,
                      miss_after_s, timeout_s, reporter,
                      plane, metrics=None, group_size=1,
                      pp_stages=1, wait_ready=False,
                      stats=None) -> Dict[int, dict]:
    from .shard_group import plan_groups

    plane = plane or _mk_plane(0, size)
    tr = _tracing.get_tracer()
    # Shard groups: only leaders carry CMD/EVT/SNAP edges.  Follower
    # ranks are invisible here — their death surfaces as the LEADER's
    # edge dying (the leader exits on intra-group PeerGone), so every
    # liveness / failover / gossip structure below keys on leader ranks
    # and needs no group awareness.
    replica_ranks = [
        g.leader for g in plan_groups(size, group_size, pp_stages)
    ]
    alive = set(replica_ranks)
    # Role map is declared up-front (the launcher knows what it started)
    # and refined by load reports as replicas phone home.
    roles = {r: "both" for r in replica_ranks} | dict(roles or {})
    loads: Dict[int, ReplicaLoad] = {}
    assigned: Dict[int, set] = {r: set() for r in replica_ranks}
    health = HeartbeatMonitor(replica_ranks, miss_after_s=miss_after_s)
    # Cluster-global prefix index: digest snapshots ride the load beats
    # (versioned anti-entropy — see cluster/prefix_gossip.py), so
    # pick_replica below can score a prompt's prefix affinity for
    # replicas this router has never sent it to.
    gossip = PrefixGossip()
    # Fleet metrics view: Reporter snapshots ride the same beats with
    # the same strictly-newer anti-entropy (cluster/metrics_gossip.py).
    metrics = metrics if metrics is not None else MetricsGossip()
    reqs: Dict[int, _RemoteRequest] = {}
    pending: List[_RemoteRequest] = []
    prefilling: Dict[int, int] = {}  # gid -> prefill replica
    migrating: Dict[int, tuple] = {}  # gid -> (src, dest)
    t_start = time.monotonic()
    released = [None if wait_ready else t_start]

    def stamp(rr: _RemoteRequest) -> None:
        rr.token_times.append(time.monotonic() - released[0])

    for gid, spec in enumerate(requests):
        spec = dict(spec)
        spec.setdefault("sampling", {})
        spec.setdefault("stop_token", None)
        spec.setdefault("timeout_s", None)
        # Optional placement gate: hold this request back until every
        # listed gid has finished (deterministic multi-wave workloads —
        # the gossip soak's second wave arrives only after the first
        # wave's pages are registered and gossiped).
        spec.setdefault("after_gids", None)
        # Optional gossip gate: hold this request back until the
        # cluster-global index advertises at least this many leading
        # pages of ITS OWN prompt on some live replica.  Unlike
        # after_gids this opens MID-flight: streaming prefix
        # registration publishes a long document's slices while its
        # first request is still prefilling, so a gated follower
        # arrives mid-prefill and must be routed by the gossiped
        # partial-prefix view alone.
        spec.setdefault("after_index_pages", None)
        # Accounting identity (per-tenant counters + SLO burn).
        spec.setdefault("tenant", None)
        # Prefix-cache isolation: page digests are salted with the
        # tenant namespace unless the request opts into the shared
        # namespace (common system prompts).  See kv_cache.prefix_digest.
        spec.setdefault("shared_prefix", False)
        rr = _RemoteRequest(gid, spec)
        if tr is not None:
            root_attrs = dict(rid=gid, prompt_len=len(spec["prompt"]),
                              max_new_tokens=spec["max_new_tokens"])
            if spec["tenant"] is not None:
                root_attrs["tenant"] = spec["tenant"]
            rr.trace = tr.begin("request", **root_attrs)
        reqs[gid] = rr
        pending.append(rr)

    def wire_trace(rr: _RemoteRequest):
        return rr.trace.to_wire() if rr.trace is not None else None

    def close_trace(rr: _RemoteRequest) -> None:
        if tr is not None and rr.trace is not None:
            root, rr.trace = rr.trace, None
            tr.end(root, error=rr.error, status=rr.status,
                   tokens=len(rr.tokens), failovers=rr.failovers)

    def send_cmd(rank: int, msg: dict) -> bool:
        try:
            plane.send(msg, rank, tag=CMD)
            return True
        except PeerGone:
            on_dead(rank, "send failed: peer gone")
            return False

    def pick_replica(rr: _RemoteRequest) -> Optional[int]:
        best, best_key = None, None
        prompt = rr.spec["prompt"]
        digests_by_bs: Dict[int, list] = {}
        for r in sorted(alive):
            if roles.get(r) == "prefill":
                continue
            ld = loads.get(r)
            if ld is not None:
                if ld.queue_depth >= ld.max_queue:
                    continue
                # Remote prefix affinity from the gossiped digest view:
                # the same 1.5x term the in-process router applies, so
                # same-template traffic converges on the replica already
                # warm for it.  Stale gossip is safe — the replica's own
                # admission re-probes its local index, and a phantom hit
                # degrades to a full local prefill, never a wrong stream.
                prefix_frac = 0.0
                if prompt and not rr.tokens and ld.block_size > 0:
                    bs = ld.block_size
                    if bs not in digests_by_bs:
                        # Salted with the request's namespace, so a
                        # tenant only scores affinity against pages it
                        # may actually reuse.
                        digests_by_bs[bs] = prompt_digests(
                            prompt, bs,
                            namespace=(None if rr.spec["shared_prefix"]
                                       else rr.spec["tenant"]),
                        )
                    hit = gossip.hit_pages(digests_by_bs[bs], r)
                    prefix_frac = min(
                        1.0, hit * bs / max(1, len(prompt))
                    )
                score = ReplicaRouter.score(ld, prefix_frac)
                # Warm-ladder affinity (same +0.25 nudge as the
                # in-process router): the gossiped max_bucket names
                # the longest context the replica has already traced
                # programs for, so long prompts avoid a cold-compile
                # replica when a warm one admits them.
                if (not rr.tokens and ld.max_bucket > 0
                        and ld.max_bucket >= len(prompt)):
                    score += 0.25
                key = (score, -r)
            else:
                key = (0.0, -r)  # cold replica: neutral score
            if best_key is None or key > best_key:
                best, best_key = r, key
        return best

    def place(rr: _RemoteRequest) -> bool:
        t0 = tr.clock() if (tr is not None and rr.trace) else 0.0
        r = pick_replica(rr)
        if r is None:
            return False
        ok = send_cmd(r, {
            "op": "submit", "gid": rr.gid,
            "prompt": list(rr.spec["prompt"]),
            "max_new_tokens": rr.spec["max_new_tokens"],
            "sampling": rr.spec["sampling"],
            "stop_token": rr.spec["stop_token"],
            "timeout_s": rr.spec["timeout_s"],
            "committed": list(rr.tokens),
            "trace": wire_trace(rr),
            "tenant": rr.spec["tenant"],
            "shared_prefix": rr.spec["shared_prefix"],
        })
        if ok:
            if tr is not None and rr.trace is not None:
                tr.record_span("placement", rr.trace, t0,
                               tr.clock() - t0, target=r,
                               committed=len(rr.tokens))
            rr.replica = r
            rr.status = "routed"
            assigned[r].add(rr.gid)
            # Count the placement into the cached load until the next
            # beat replaces it (a port addition): the reference scores a
            # whole pass on the same stale loads, so every request of a
            # burst lands on one replica until its queue rejects.
            if r in loads:
                loads[r] = dataclasses.replace(
                    loads[r], queue_depth=loads[r].queue_depth + 1)
        return ok

    def on_dead(rank: int, why: str) -> None:
        if rank not in alive:
            return
        alive.discard(rank)
        health.mark_dead(rank)
        gossip.forget(rank)
        # The dead replica's snapshot — and with it every one of its
        # per-replica series — leaves the fleet view immediately; its
        # router-side gauges go with it (stale-series fix).
        metrics.forget(rank)
        if reporter is not None:
            reporter.forget_replica(rank)
        for gid in sorted(assigned.pop(rank, set())):
            rr = reqs[gid]
            if rr.done:
                continue
            rr.failovers += 1
            rr.status = "pending"
            rr.replica = None
            if tr is not None and rr.trace is not None:
                tr.event("failover", rr.trace, reason=why,
                         from_replica=rank, committed=len(rr.tokens))
            pending.append(rr)
        for gid, pr in list(prefilling.items()):
            if pr == rank:
                del prefilling[gid]
                rr = reqs[gid]
                if not rr.done:
                    rr.failovers += 1
                    rr.status = "pending"
                    pending.append(rr)
        for gid, (src, dest) in list(migrating.items()):
            if rank in (src, dest):
                del migrating[gid]
                rr = reqs[gid]
                if not rr.done:
                    rr.failovers += 1
                    rr.status = "pending"
                    pending.append(rr)

    def handle_evt(rank: int, events: list) -> None:
        health.beat(rank)
        for ev in events:
            kind = ev[0]
            if kind == "tok":
                _, gid, tok = ev
                rr = reqs[gid]
                rr.tokens.append(int(tok))
                stamp(rr)
                if tr is not None and rr.trace is not None:
                    tr.token(rr.trace)
            elif kind == "done":
                _, gid, status, error = ev
                rr = reqs[gid]
                rr.status = status
                rr.error = error
                assigned.get(rank, set()).discard(gid)
                if rr.done:
                    close_trace(rr)
            elif kind == "reject":
                _, gid, _retry = ev
                rr = reqs[gid]
                assigned.get(rank, set()).discard(gid)
                rr.status = "pending"
                rr.replica = None
                pending.append(rr)
            elif kind == "handoff_ready":
                _, gid, tok = ev
                rr = reqs[gid]
                rr.tokens.append(int(tok))  # committed exactly once
                stamp(rr)
                if tr is not None and rr.trace is not None:
                    tr.token(rr.trace)
                del prefilling[gid]
                if (
                    len(rr.tokens) >= rr.spec["max_new_tokens"]
                    or tok == rr.spec["stop_token"]
                ):
                    rr.status = "finished"
                    close_trace(rr)
                    continue
                dest = pick_replica(rr)
                if dest is None:
                    rr.status = "pending"
                    pending.append(rr)
                    continue
                gdest = plane.members[dest]
                gsrc = plane.members[rank]
                migrating[gid] = (rank, dest)
                if send_cmd(rank, {"op": "send_snapshot", "gid": gid,
                                   "dest": gdest,
                                   "trace": wire_trace(rr)}):
                    send_cmd(dest, {
                        "op": "recv_snapshot", "gid": gid,
                        "source": gsrc,
                        "prompt": list(rr.spec["prompt"]),
                        "max_new_tokens": rr.spec["max_new_tokens"],
                        "sampling": rr.spec["sampling"],
                        "stop_token": rr.spec["stop_token"],
                        "timeout_s": rr.spec["timeout_s"],
                        "committed": list(rr.tokens),
                        "trace": wire_trace(rr),
                        "tenant": rr.spec["tenant"],
                        "shared_prefix": rr.spec["shared_prefix"],
                    })
            elif kind == "adopted":
                _, gid = ev
                rr = reqs[gid]
                migrating.pop(gid, None)
                rr.replica = rank
                rr.status = "routed"
                assigned[rank].add(gid)
            elif kind == "handoff_failed":
                _, gid, err = ev
                rr = reqs[gid]
                prefilling.pop(gid, None)
                migrating.pop(gid, None)
                if not rr.done:
                    # Fall back to the plain path: re-prefill on a
                    # decode replica with whatever prefix is committed.
                    rr.failovers += 1
                    rr.status = "pending"
                    pending.append(rr)
            elif kind == "load":
                loads[rank] = ReplicaLoad.from_dict(ev[1])
                roles[rank] = loads[rank].role
                gossip.observe(rank, loads[rank].prefix_version,
                               loads[rank].prefix_digests)
                metrics.observe(rank, loads[rank].metrics_version,
                                loads[rank].metrics)

    deadline = time.monotonic() + timeout_s
    while any(not rr.done for rr in reqs.values()):
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"router did not finish within {timeout_s}s: "
                f"{[(g, r.status) for g, r in reqs.items()]}"
            )
        if not alive:
            for rr in reqs.values():
                if not rr.done:
                    rr.status = "failed"
                    rr.error = "every replica died"
                    close_trace(rr)
            break
        for rank in health.check():
            on_dead(rank, "missed heartbeats")
        if released[0] is None and all(r in loads for r in alive):
            released[0] = time.monotonic()
        # Place pending work.
        still: List[_RemoteRequest] = []
        for rr in (pending if released[0] is not None else ()):
            if rr.done:
                continue
            gate = rr.spec["after_gids"]
            if gate and any(not reqs[g].done for g in gate):
                still.append(rr)
                continue
            prompt = rr.spec["prompt"]
            pages_gate = rr.spec["after_index_pages"]
            if pages_gate and not rr.tokens:
                digs: Dict[int, list] = {}
                warm = False
                for r in sorted(alive):
                    ld = loads.get(r)
                    if ld is None or ld.block_size <= 0:
                        continue
                    bs = ld.block_size
                    if bs not in digs:
                        digs[bs] = prompt_digests(
                            prompt, bs,
                            namespace=(
                                None if rr.spec["shared_prefix"]
                                else rr.spec["tenant"]
                            ),
                        )
                    if gossip.hit_pages(digs[bs], r) >= pages_gate:
                        warm = True
                        break
                if not warm:
                    still.append(rr)
                    continue
            prefills = [
                r for r in sorted(alive) if roles.get(r) == "prefill"
            ]
            if (
                prefill_threshold is not None
                and not rr.tokens
                and len(prompt) >= prefill_threshold
                and prefills
            ):
                pr = min(prefills)
                if send_cmd(pr, {
                    "op": "prefill", "gid": rr.gid,
                    "prompt": list(prompt),
                    "sampling": rr.spec["sampling"],
                    "trace": wire_trace(rr),
                }):
                    if tr is not None and rr.trace is not None:
                        tr.record_span("placement", rr.trace,
                                       tr.clock(), 0.0, target=pr,
                                       kind="prefill")
                    prefilling[rr.gid] = pr
                    rr.status = "prefill"
                    continue
            if not place(rr):
                still.append(rr)
        if released[0] is not None:
            pending = still
        # Drain events from every replica.
        for rank in sorted(alive):
            while True:
                try:
                    events = plane.recv(rank, tag=EVT,
                                        timeout_ms=POLL_MS)
                except TimeoutError:
                    break
                except PeerGone as e:
                    on_dead(rank, str(e))
                    break
                handle_evt(rank, events)
        if reporter is not None:
            reporter.gauge("serving/cluster/replicas_alive", len(alive))
    t_end = time.monotonic()
    for rank in sorted(alive):
        send_cmd(rank, {"op": "stop"})
    for rr in reqs.values():
        close_trace(rr)  # no-op for roots already ended
    if stats is not None:
        rel = released[0] if released[0] is not None else t_end
        stats["ready_s"] = rel - t_start
        stats["serve_wall_s"] = t_end - rel
    return {
        gid: {
            "tokens": list(rr.tokens),
            "status": rr.status,
            "error": rr.error,
            "failovers": rr.failovers,
            "replica": rr.replica,
            "token_times": list(rr.token_times),
        }
        for gid, rr in reqs.items()
    }
