"""Multi-replica serving tier — port of ``chainermn_tpu/serving/cluster``:
load-aware routing, prefill/decode disaggregation, KV-page migration,
heartbeats, gossip, failover and autoscaling over the port's engine,
scheduler and frontend, in one process or one process a replica.

* :mod:`replica` — one engine+scheduler+frontend unit with a serving
  *role* (``prefill`` / ``decode`` / ``both``) and a load snapshot;
* :mod:`router` — load/deadline-aware request placement, failover
  re-queue from the committed token prefix (bit-exact by the engine's
  counter-based sampling);
* :mod:`disagg` — prefill-role replicas run the prompts and hand the
  finished KV pages to decode-role replicas;
* :mod:`migration` — a live sequence's KV pages and block-table slice
  moved between pools (in process, or over an object plane);
* :mod:`prefix_gossip` and :mod:`metrics_gossip` — the cluster-global
  prefix index and fleet metrics view, merged strictly-newer;
* :mod:`health` — heartbeat liveness and watermark scale/drain signals;
* :mod:`autoscaler` — the closed-loop controller acting on those signals,
  the SLO burn-rate gauges and an optional anomaly detector: spawn on
  pressure, drain → migrate → retire on idleness, backfill on death;
* :mod:`driver` — threaded per-replica stepping;
* :mod:`service` — router/replica event loops over the host object plane
  (``communicators.kvtransport``) for one process a replica
  (``python -m chainermn_tpu_torch.tools.serve``);
* :mod:`shard_group` — a replica as a multi-process shard group (leader +
  lockstep follower mirrors, group id = leader rank, any-shard death
  fails the whole group).

In one process, several replicas on one card may share one
``TransformerLM`` (the weights are read-only while serving); each
replica's engine owns its pages.  Across processes every process builds
the same module from the same seed, and nothing on the wire is a
``torch.Tensor``.
"""

from . import service, shard_group
from .autoscaler import Autoscaler, AutoscalerConfig
from .disagg import PrefillJob, PrefillResult
from .driver import ThreadedClusterDriver
from .health import HeartbeatMonitor, ScaleSignalFilter, scale_signals
from .metrics_gossip import MetricsGossip
from .migration import (
    KVSnapshot,
    extract_sequence,
    recv_snapshot,
    restore_sequence,
    send_snapshot,
)
from .prefix_gossip import PrefixGossip
from .replica import Replica, ReplicaLoad
from .router import ClusterHandle, ReplicaRouter
from .shard_group import GroupLeader, GroupSpec, plan_groups, run_follower

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "ClusterHandle",
    "GroupLeader",
    "GroupSpec",
    "HeartbeatMonitor",
    "KVSnapshot",
    "MetricsGossip",
    "PrefillJob",
    "PrefillResult",
    "PrefixGossip",
    "Replica",
    "ReplicaLoad",
    "ReplicaRouter",
    "ScaleSignalFilter",
    "ThreadedClusterDriver",
    "extract_sequence",
    "plan_groups",
    "recv_snapshot",
    "restore_sequence",
    "run_follower",
    "scale_signals",
    "send_snapshot",
    "service",
    "shard_group",
]
