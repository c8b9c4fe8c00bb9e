"""Cluster-global prefix index: versioned anti-entropy over load beats.

Each replica's :class:`~chainermn_tpu_torch.serving.kv_cache.PagedKVCache`
keeps a monotone ``index_version`` and can digest its prefix-index keys
(:func:`~chainermn_tpu_torch.serving.kv_cache.prefix_digest` — content-
addressed 64-bit blake2b of the cumulative token run, so the identity
is defrag-stable and platform-independent).  Replicas publish
``(version, digests)`` piggybacked on the load beats they already send
(:meth:`cluster.replica.Replica.load`); any router — the in-process
:class:`~chainermn_tpu_torch.serving.cluster.router.ReplicaRouter` or the
service-loop router in :mod:`cluster.service` — feeds them into a
:class:`PrefixGossip` and can then score *remote* prefix hits for a
prompt it has never sent anywhere: it computes the prompt's own page
digests (:func:`~chainermn_tpu_torch.serving.kv_cache.prompt_digests`) and
counts the longest leading run present in a replica's gossiped set.

Anti-entropy is last-writer-wins per replica: a snapshot replaces the
held view only when its version is strictly newer, so re-ordered or
duplicated beats are harmless.  Staleness is safe BY CONSTRUCTION
downstream: gossip only influences *routing scores* — admission on the
chosen replica always re-probes its local ``match_prefix``, so a stale
remote hit degrades to a full local prefill, never to a wrong stream.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

#: wire-size cap on the digest set one load beat carries (8 bytes per
#: digest before serialization — 512 entries ≈ 4 KiB of payload).
MAX_GOSSIP_DIGESTS = 512


class PrefixGossip:
    """Router-side view of every replica's gossiped prefix digests."""

    def __init__(self):
        # replica id -> (version, digest set)
        self._view: Dict[object, Tuple[int, frozenset]] = {}

    def observe(self, replica_id, version: int,
                digests: Sequence[int]) -> bool:
        """Fold one ``(version, digests)`` snapshot from ``replica_id``
        into the view; applied only when strictly newer than what is
        held (idempotent under duplicated / re-ordered beats).  Returns
        whether the view changed."""
        held = self._view.get(replica_id)
        version = int(version)
        if held is not None and version <= held[0]:
            return False
        self._view[replica_id] = (
            version, frozenset(int(d) for d in digests)
        )
        return True

    def forget(self, replica_id) -> None:
        """Drop a replica's view (death / retirement) so its stale
        digests stop attracting traffic."""
        self._view.pop(replica_id, None)

    def version(self, replica_id) -> Optional[int]:
        held = self._view.get(replica_id)
        return None if held is None else held[0]

    def replicas(self) -> List[object]:
        return list(self._view)

    def hit_pages(self, digests: Sequence[int], replica_id) -> int:
        """Longest leading run of ``digests`` (a prompt's cumulative
        page digests, in prompt order) present in ``replica_id``'s
        gossiped set — the remote analogue of ``len(match_prefix(...))``.
        Leading-run semantics match the local index: a sequence can only
        share pages covering an unbroken head of its prompt."""
        held = self._view.get(replica_id)
        if held is None:
            return 0
        have = held[1]
        n = 0
        for d in digests:
            if int(d) not in have:
                break
            n += 1
        return n

    def best(self, digests: Sequence[int]) -> Tuple[Optional[object], int]:
        """The replica with the deepest leading hit for ``digests`` and
        its page count — (None, 0) when nobody holds the head page."""
        best_id, best_n = None, 0
        for rid in self._view:
            n = self.hit_pages(digests, rid)
            if n > best_n:
                best_id, best_n = rid, n
        return best_id, best_n
