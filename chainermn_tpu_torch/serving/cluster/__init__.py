"""Multi-replica serving tier, in one process — port of
``chainermn_tpu/serving/cluster``'s in-process half: load-aware routing,
prefill/decode disaggregation, KV-page migration, heartbeats, gossip and
failover over the port's engine, scheduler and frontend.

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
* :mod:`driver` — threaded per-replica stepping.

Several replicas on one card may share one ``TransformerLM`` (the weights
are read-only while serving); each replica's engine owns its pages.  The
multi-process tier (the service loops, shard groups, the autoscaler and
their host transport) is a later slice (ROADMAP A.6).
"""

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

__all__ = [
    "ClusterHandle",
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
    "recv_snapshot",
    "restore_sequence",
    "scale_signals",
    "send_snapshot",
]
