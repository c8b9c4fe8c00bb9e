"""Fleet metrics view: Reporter snapshots carried on load beats.

The same anti-entropy shape as :mod:`cluster.prefix_gossip`, applied to
telemetry: each replica stamps its local
:meth:`~chainermn_tpu_torch.observability.reporter.Reporter.summary` with a
monotone version and piggybacks it on the :class:`ReplicaLoad` beats it
already sends — no new channel, no collective, nothing a jitted program
sees.  The router folds the latest snapshot per replica through
:func:`~chainermn_tpu_torch.observability.reporter.merge_summaries` into one
**fleet view** it serves at its own ``/metrics``.

Why last-writer-wins full snapshots instead of literal increments: a
Reporter summary is already cumulative (counters only grow, histogram
buckets only fill), so the newest snapshot *is* the replica's whole
history and replacing the held one both applies the delta and heals any
missed beat.  Duplicated or re-ordered beats are no-ops by the strict
version check — the merge is idempotent, exactly like the prefix index.

``forget`` (wired to the router's ``health.forget`` /
``retire_replica`` / failover paths) drops a dead replica's snapshot,
so its per-replica series leave the fleet view within one beat of the
death verdict.  Fleet-level counters may step back when a replica's
contribution leaves the merge — consumers that need monotonicity read
per-replica series, which never regress while present.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ...observability.reporter import merge_summaries

__all__ = ["MetricsGossip"]


class MetricsGossip:
    """Router-side holder of the latest Reporter snapshot per replica."""

    def __init__(self):
        # replica id -> (version, summary dict)
        self._view: Dict[object, Tuple[int, dict]] = {}

    def observe(self, replica_id, version: int,
                summary: Optional[dict]) -> bool:
        """Fold one ``(version, summary)`` beat payload; applied only
        when strictly newer than what is held.  ``None`` summaries
        (beats from peers predating the field, or replicas running
        without a reporter) are ignored.  Returns whether the view
        changed."""
        if summary is None:
            return False
        held = self._view.get(replica_id)
        version = int(version)
        if held is not None and version <= held[0]:
            return False
        self._view[replica_id] = (version, summary)
        return True

    def forget(self, replica_id) -> None:
        """Drop a replica's snapshot (death / retirement): its series
        disappear from the next :meth:`fleet_view`."""
        self._view.pop(replica_id, None)

    def version(self, replica_id) -> Optional[int]:
        held = self._view.get(replica_id)
        return None if held is None else held[0]

    def replicas(self) -> List[object]:
        return list(self._view)

    def latest(self, replica_id) -> Optional[dict]:
        held = self._view.get(replica_id)
        return None if held is None else held[1]

    def fleet_view(self, extra: Optional[List[dict]] = None) -> dict:
        """One merged summary over every live replica's latest snapshot
        plus ``extra`` summaries (the router's own Reporter) — the dict
        the router's ``/metrics`` endpoint renders."""
        snaps = list(extra) if extra else []
        # deterministic merge order (gauge "value" is merge-order
        # dependent); sort by stringified replica id
        for rid in sorted(self._view, key=str):
            snaps.append(self._view[rid][1])
        return merge_summaries(snaps)
