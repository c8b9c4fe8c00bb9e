"""Paged KV cache accounting — block tables, alloc/free, prefix sharing.

Port of ``chainermn_tpu/serving/kv_cache.py``: numpy host accounting,
copied as it is (digests, LRU cached pool, copy-on-write refcounts,
page-seconds and ``defragment``'s permutation are the reference's).

The device-side pages (the ``(n_blocks, block_size, n_kv, d_head)``
arrays each attention layer reads and writes) live in the serving
engine's flax ``cache`` collection; THIS class is the host-side memory
manager that decides which page holds which token — the vLLM
``BlockAllocator``/block-table split, sized so the whole thing is plain
deterministic Python:

* one free list (LIFO — O(1), and deterministic so two runs of the same
  request trace allocate identical physical pages);
* one block table per live sequence: the ordered page ids covering token
  positions ``[0, seq_len)``, position ``t`` living in
  ``table[t // block_size]`` at slot ``t % block_size``;
* a **prefix index** (vLLM/SGLang RadixAttention direction): full pages
  whose token-id run is known are registered under the cumulative token
  prefix they cover, so a later request with the same prompt prefix
  *shares* those pages instead of re-prefilling them.  Shared pages
  carry a refcount (number of referencing block tables); a page whose
  refcount drops to zero but is still registered parks in a ``cached``
  LRU pool — reclaimable, but resurrectable by the next prefix hit;
* copy-on-write: before any write into a shared or registered page the
  caller asks :meth:`make_writable`, which splits the page (fresh copy
  for the writer, original stays in the index for everyone else);
* conservation invariants checked on every mutation in
  :meth:`assert_consistent` — every page is exactly one of free, cached,
  or referenced by ≥1 table with a matching refcount.

Eviction is *recomputable* preemption: :meth:`free` detaches the pages
(shared ones simply drop a reference) and the scheduler re-prefills the
sequence when it is re-admitted — no swap-out copy, the standard
recompute-beats-copy trade at small sequence lengths; re-admission then
re-hits the prefix index, so a preempted sequence usually re-prefills
only its un-shared suffix.

:meth:`defragment` compacts live pages (tabled *and* cached — cached
pages are live content, they are the prefix cache) to the lowest
indices, rewriting every referencing table — a shared page moves once
and every table sees the move — and returns the permutation the engine
applies to the device pages.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.decode_attention import invalid_block


def prefix_digest(token_ids: Sequence[int],
                  namespace: Optional[str] = None) -> int:
    """Content-addressed 64-bit digest of one prefix-index key (a
    cumulative full-page token prefix).  blake2b over the little-endian
    int64 token run, so two replicas computing the digest of the same
    prompt prefix agree regardless of platform — the identity the
    cluster-global prefix index gossips.  Defrag-stable for free: index
    KEYS are token runs; :meth:`PagedKVCache.defragment` rewrites only
    the page ids behind them.

    ``namespace`` salts the digest: a tenant-private prefix run hashes
    under its tenant id, so one tenant's gossiped digests can never
    collide with (and thus never confirm the existence of) another
    tenant's prompts — the cross-tenant timing side-channel closes at
    the identity layer, and the gossip plane carries salted digests
    with no wire change.  ``None`` (the shared namespace) reproduces
    the historical digest bit-for-bit."""
    data = np.asarray(list(token_ids), dtype="<i8").tobytes()
    if namespace is not None:
        data = str(namespace).encode("utf-8") + b"\x00" + data
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8).digest(), "big"
    )


def prompt_digests(token_ids: Sequence[int], block_size: int,
                   namespace: Optional[str] = None) -> List[int]:
    """Digests of every full-page cumulative prefix of ``token_ids`` —
    what a router computes from a *prompt alone* to probe a remote
    replica's gossiped digest set (the remote analogue of
    :meth:`PagedKVCache.match_prefix`).  ``namespace`` salts each
    digest exactly as :func:`prefix_digest` does."""
    toks = [int(t) for t in token_ids]
    bs = int(block_size)
    if bs <= 0:
        return []
    return [prefix_digest(toks[: (i + 1) * bs], namespace)
            for i in range(len(toks) // bs)]


class OutOfBlocks(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list
    plus the reclaimable cached pool.  The scheduler catches this and
    preempts (evicts) a victim sequence."""


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Occupancy snapshot — the numbers the Reporter gauges publish.

    ``free_blocks`` counts *reclaimable* capacity: truly-free pages plus
    cached (refcount-0 prefix) pages, which any allocation may evict.
    ``cached_blocks`` breaks out the prefix-cache share of that."""

    n_blocks: int
    block_size: int
    used_blocks: int
    free_blocks: int
    cached_blocks: int
    n_seqs: int
    utilization: float  # used / total, in [0, 1]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PagedKVCache:
    """Host-side page accounting for a fixed pool of KV pages.

    ``n_blocks`` pages of ``block_size`` tokens each.  Sequence ids are
    caller-chosen hashables (the scheduler uses request ids).

    ``prefix_cache=False`` disables the prefix index entirely:
    :meth:`match_prefix` returns nothing and :meth:`register_prefix` is
    a no-op, which reduces every code path below to the pre-sharing
    behaviour (all refcounts 1, cached pool empty).
    """

    def __init__(self, n_blocks: int, block_size: int, *,
                 prefix_cache: bool = True,
                 clock: Optional[Callable[[], float]] = None):
        if n_blocks <= 0 or block_size <= 0:
            raise ValueError("n_blocks and block_size must be positive")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.prefix_cache = bool(prefix_cache)
        #: the scatter/gather sentinel for unallocated table slots.
        self.invalid = invalid_block(self.n_blocks)
        # LIFO free list, seeded high-to-low so the first allocations
        # take pages 0, 1, 2, … (the dense-prefix layout defragment
        # restores).
        self._free: List[int] = list(range(self.n_blocks - 1, -1, -1))
        self._tables: Dict[object, List[int]] = {}
        self._lens: Dict[object, int] = {}
        #: per-page reference count — one entry per page held by ≥1 table.
        self._ref: Dict[int, int] = {}
        # Prefix index: cumulative token prefix (full pages only) → the
        # page holding its LAST block, plus the reverse map.  Registered
        # pages with refcount 0 park in the LRU ``_cached`` pool
        # (front = oldest = first evicted).
        self._index: Dict[Tuple[Optional[str], Tuple[int, ...]], int] = {}
        self._index_key_of: Dict[
            int, Tuple[Optional[str], Tuple[int, ...]]
        ] = {}
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        #: monotone prefix-index version — bumped on every index
        #: mutation, the anti-entropy stamp the gossip plane publishes
        #: alongside the digest set (cluster/prefix_gossip.py).
        self._index_version = 0
        #: page moves performed by the most recent :meth:`defragment`.
        self._last_defrag_moves = 0
        #: (old, new) CoW splits performed by the most recent
        #: :meth:`make_writable` (the engine copies the device page).
        self._last_cow_split: Optional[Tuple[int, int]] = None
        # Per-tenant page-second accounting.  Every page with refcount
        # ≥ 1 has exactly one OWNER — the tenant whose sequence first
        # pulled it to refcount 1 (shared prefix pages accrue to their
        # first owner only, never double-billed).  Accrual happens
        # lazily: every mutating entry point calls :meth:`_accrue`
        # BEFORE changing any hold count, so each tenant's integral is
        # exact and the sum over tenants (incl. the ``None`` bucket for
        # untenanted sequences) equals the pool's used-page integral by
        # construction.  ``clock`` is injectable for deterministic tests.
        self._clock = clock if clock is not None else time.monotonic
        self._ps_last = self._clock()
        self._page_owner: Dict[int, Optional[str]] = {}
        self._held: Dict[Optional[str], int] = {}
        self._page_seconds: Dict[Optional[str], float] = {}
        self._seq_tenant: Dict[object, Optional[str]] = {}

    # -- sizing --------------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` positions."""
        return -(-max(0, int(n_tokens)) // self.block_size)

    def _reclaimable(self) -> int:
        return len(self._free) + len(self._cached)

    def can_allocate(self, n_tokens: int, reserve: int = 0,
                     prefix_pages: Optional[Sequence[int]] = None) -> bool:
        """Whether a fresh ``n_tokens``-token sequence fits, keeping
        ``reserve`` pages untouched (the scheduler's admission watermark:
        admitting a prompt that leaves zero headroom just converts the
        next decode iteration into a preemption storm).  With
        ``prefix_pages`` (a :meth:`match_prefix` result) only the
        un-shared suffix consumes capacity — sharing is what makes a
        cache-hot prompt nearly free to admit."""
        prefix = list(prefix_pages or [])
        need = self.blocks_for(n_tokens) - len(prefix)
        avail = self._reclaimable() - sum(
            1 for p in prefix if p in self._cached
        )
        return need <= avail - reserve

    # -- prefix index --------------------------------------------------
    # Index keys are ``(namespace, token-run)`` pairs: ``namespace`` is
    # the tenant isolation domain (None = the shared namespace every
    # pre-tenant caller lives in) and the token run is the cumulative
    # full-page prefix.  Two tenants prefilling the same document get
    # DISTINCT keys — neither can observe (via admission latency or
    # gossip digests) that the other's prompt is resident.
    def match_prefix(self, token_ids,
                     namespace: Optional[str] = None) -> List[int]:
        """The longest run of FULL pages from the index covering a
        prefix of ``token_ids`` within ``namespace``.  Read-only
        (claiming happens in :meth:`allocate`); routers use it to score
        placement without perturbing the pool.  Returns page ids in
        table order."""
        if not self.prefix_cache:
            return []
        toks = tuple(int(t) for t in token_ids)
        pages: List[int] = []
        for i in range(len(toks) // self.block_size):
            page = self._index.get(
                (namespace, toks[: (i + 1) * self.block_size])
            )
            if page is None:
                break
            pages.append(page)
        return pages

    def register_prefix(self, seq_id, token_ids,
                        namespace: Optional[str] = None) -> int:
        """Publish ``seq_id``'s pages covering the full-page prefix of
        ``token_ids`` (its prompt) into the index under ``namespace``,
        so later sequences in the same namespace can share them.  Call
        only once the pages' K/V is actually written (post-prefill).
        Pages whose prefix is already indexed (including pages shared
        *from* the index at admission) are left alone.  Returns how
        many pages were newly registered."""
        if not self.prefix_cache:
            return 0
        table = self._tables[seq_id]
        toks = tuple(int(t) for t in token_ids)
        new = 0
        for i in range(len(toks) // self.block_size):
            key = (namespace, toks[: (i + 1) * self.block_size])
            page = table[i]
            if key in self._index or page in self._index_key_of:
                continue
            self._index[key] = page
            self._index_key_of[page] = key
            new += 1
        if new:
            self._index_version += 1
        return new

    @property
    def index_version(self) -> int:
        """Monotone stamp of the prefix index's current contents — the
        version the gossip plane publishes with :meth:`prefix_digests`
        so receivers can apply strictly-newer snapshots only."""
        return self._index_version

    def prefix_digests(self, limit: Optional[int] = None) -> List[int]:
        """Content digests (:func:`prefix_digest`) of every registered
        index key, optionally capped at ``limit`` entries (wire-size
        bound for the gossip payload).  Matching is set-membership on
        the receiver, so order only matters under truncation — keys
        iterate in registration order, oldest first.  Tenant-salted
        entries digest under their namespace (:func:`prefix_digest`),
        so the published set leaks nothing across tenants."""
        out = [prefix_digest(toks, ns) for ns, toks in self._index]
        if limit is not None:
            return out[: int(limit)]
        return out

    def drop_prefix_cache(self) -> int:
        """Forget every index entry and return cached (refcount-0) pages
        to the free list — the engine's :meth:`reset` hook, restoring a
        cleanly deterministic pool.  Still-tabled registered pages just
        lose their registration.  Returns pages returned to the free
        list."""
        n = len(self._cached)
        for page in self._cached:
            self._free.append(page)
        self._cached.clear()
        if self._index:
            self._index_version += 1
        self._index.clear()
        self._index_key_of.clear()
        return n

    def refcount(self, page: int) -> int:
        """Tables currently referencing ``page`` (0 = free or cached)."""
        return self._ref.get(int(page), 0)

    def is_registered(self, page: int) -> bool:
        return int(page) in self._index_key_of

    @property
    def cached_blocks(self) -> int:
        return len(self._cached)

    def _unregister(self, page: int) -> None:
        key = self._index_key_of.pop(page, None)
        if key is not None:
            del self._index[key]
            self._index_version += 1

    # -- per-tenant page-seconds ---------------------------------------
    def _accrue(self, now: Optional[float] = None) -> float:
        """Integrate held-page time up to ``now`` into each owner's
        page-second bucket.  Called at the top of every mutating entry
        point (before hold counts change), so the integrals are exact."""
        now = self._clock() if now is None else now
        dt = now - self._ps_last
        if dt > 0:
            for ten, cnt in self._held.items():
                if cnt:
                    self._page_seconds[ten] = (
                        self._page_seconds.get(ten, 0.0) + cnt * dt
                    )
        self._ps_last = now
        return now

    def _hold(self, page: int, tenant: Optional[str]) -> None:
        """Record ``tenant`` as the owner of ``page`` — called exactly
        when the page's refcount rises from 0 (free/cached) to 1."""
        self._page_owner[page] = tenant
        self._held[tenant] = self._held.get(tenant, 0) + 1

    def _unhold(self, page: int) -> None:
        ten = self._page_owner.pop(page)
        self._held[ten] -= 1

    def page_seconds(self, now: Optional[float] = None
                     ) -> Dict[str, float]:
        """Per-tenant KV residency integral: {tenant: page·seconds held
        so far}.  Untenanted holdings are excluded here but still count
        toward :meth:`pool_page_seconds`, so with all-tenanted traffic
        ``sum(page_seconds().values()) == pool_page_seconds()``
        exactly."""
        self._accrue(now)
        return {str(t): v for t, v in self._page_seconds.items()
                if t is not None}

    def pool_page_seconds(self, now: Optional[float] = None) -> float:
        """The pool's used-page integral ∫ used_blocks dt — by
        construction the exact sum of every owner bucket (tenanted and
        untenanted)."""
        self._accrue(now)
        return sum(self._page_seconds.values())

    def _release(self, page: int) -> None:
        """Drop one reference; at zero the page parks in the cached pool
        (if registered) or returns to the free list."""
        self._ref[page] -= 1
        if self._ref[page] > 0:
            return
        del self._ref[page]
        self._unhold(page)
        if page in self._index_key_of:
            self._cached[page] = None  # most-recently released
        else:
            self._free.append(page)

    def _pop_page(self) -> int:
        """A writable page: the free list first, else evict the oldest
        cached (refcount-0 registered) page — deterministic LRU."""
        if self._free:
            return self._free.pop()
        if self._cached:
            page, _ = self._cached.popitem(last=False)
            self._unregister(page)
            return page
        raise OutOfBlocks("no free or reclaimable cached pages")

    # -- alloc/extend/free ---------------------------------------------
    def allocate(self, seq_id, n_tokens: int,
                 prefix_pages: Optional[Sequence[int]] = None,
                 tenant: Optional[str] = None) -> List[int]:
        """Create a sequence covering ``n_tokens`` positions; returns its
        block table (also readable via :meth:`block_table`).

        ``prefix_pages`` — a :meth:`match_prefix` result for this
        sequence's leading tokens — become the table's head *shared*:
        each gains a reference (cached pages are resurrected from the
        pool), and only the remaining suffix draws fresh pages.

        ``tenant`` — accounting identity pages first held by this
        sequence accrue page-seconds under (:meth:`page_seconds`)."""
        self._accrue()
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already allocated")
        prefix = [int(p) for p in (prefix_pages or [])]
        need = self.blocks_for(n_tokens) - len(prefix)
        if need < 0:
            raise ValueError(
                f"{len(prefix)} prefix pages exceed the "
                f"{self.blocks_for(n_tokens)} needed for {n_tokens} tokens"
            )
        for p in prefix:
            if p not in self._index_key_of:
                raise ValueError(f"prefix page {p} is not registered")
        avail = self._reclaimable() - sum(
            1 for p in prefix if p in self._cached
        )
        if need > avail:
            raise OutOfBlocks(
                f"need {need} fresh pages for {n_tokens} tokens "
                f"({len(prefix)} shared), {avail} reclaimable"
            )
        # Claim the shared head first so LRU eviction can't steal it.
        for p in prefix:
            if p in self._cached:
                del self._cached[p]
            if self._ref.get(p, 0) == 0:
                self._hold(p, tenant)
            self._ref[p] = self._ref.get(p, 0) + 1
        fresh = [self._pop_page() for _ in range(need)]
        for p in fresh:
            self._ref[p] = 1
            self._hold(p, tenant)
        table = prefix + fresh
        self._tables[seq_id] = table
        self._lens[seq_id] = int(n_tokens)
        self._seq_tenant[seq_id] = tenant
        return list(table)

    def extend(self, seq_id, new_len: int) -> List[int]:
        """Grow ``seq_id`` to cover ``new_len`` positions; returns the
        newly allocated page ids (often empty — growth only crosses a
        page boundary every ``block_size`` tokens)."""
        self._accrue()
        table = self._tables[seq_id]
        need = self.blocks_for(new_len) - len(table)
        if need > self._reclaimable():
            raise OutOfBlocks(
                f"extending {seq_id!r} to {new_len} tokens needs {need} "
                f"pages, {self._reclaimable()} reclaimable"
            )
        tenant = self._seq_tenant.get(seq_id)
        fresh = [self._pop_page() for _ in range(max(0, need))]
        for p in fresh:
            self._ref[p] = 1
            self._hold(p, tenant)
        table.extend(fresh)
        self._lens[seq_id] = max(self._lens[seq_id], int(new_len))
        return fresh

    def truncate(self, seq_id, new_len: int) -> int:
        """Shrink ``seq_id``'s coverage to ``new_len`` positions,
        releasing trailing pages (speculative verify over-extends by the
        draft length, then gives back what the accepted run didn't
        need).  Returns how many pages were released."""
        self._accrue()
        table = self._tables[seq_id]
        keep = self.blocks_for(new_len)
        dropped = 0
        while len(table) > keep:
            self._release(table.pop())
            dropped += 1
        self._lens[seq_id] = int(new_len)
        return dropped

    def free(self, seq_id) -> int:
        """Detach every page of ``seq_id`` (shared pages drop one
        reference; sole-owner registered pages park in the cached pool);
        returns how many pages were detached."""
        self._accrue()
        table = self._tables.pop(seq_id)
        self._lens.pop(seq_id)
        self._seq_tenant.pop(seq_id, None)
        for page in reversed(table):
            self._release(page)
        return len(table)

    def adopt_prefix(self, seq_id, pages: Sequence[int],
                     start_idx: int = 0) -> int:
        """Swap the head of ``seq_id``'s table for the registered
        ``pages`` (a :meth:`match_prefix` result), sharing them instead
        of the sequence's own copies — the streaming-prefill analogue of
        passing ``prefix_pages`` to :meth:`allocate`: a request that is
        mid-chunked-prefill when another sequence registers a deeper run
        of the same document adopts the already-written pages and skips
        recomputing them.  Entries below ``start_idx`` and entries
        already holding the shared page are left alone.  Each swap
        claims the shared page (resurrecting it from the cached pool if
        parked) and releases the sequence's own page, so the pool never
        grows — adoption cannot raise :class:`OutOfBlocks`.  Returns how
        many table entries were swapped."""
        self._accrue()
        table = self._tables[seq_id]
        pages = [int(p) for p in pages]
        if len(pages) > len(table):
            raise ValueError(
                f"{len(pages)} adopted pages exceed the "
                f"{len(table)}-page table of {seq_id!r}"
            )
        swapped = 0
        for i in range(int(start_idx), len(pages)):
            page = pages[i]
            if table[i] == page:
                continue
            if page not in self._index_key_of:
                raise ValueError(
                    f"adopted page {page} is not registered"
                )
            # Claim before release: the swap is reference-neutral, so
            # no eviction can run between the two halves.
            if page in self._cached:
                del self._cached[page]
            if self._ref.get(page, 0) == 0:
                self._hold(page, self._seq_tenant.get(seq_id))
            self._ref[page] = self._ref.get(page, 0) + 1
            self._release(table[i])
            table[i] = page
            swapped += 1
        return swapped

    # -- copy-on-write -------------------------------------------------
    def make_writable(self, seq_id, position: int) -> Optional[Tuple[int, int]]:
        """Guarantee the page holding ``position`` is privately owned by
        ``seq_id`` before a K/V write lands there.

        Shared (refcount > 1) or index-registered pages are split: a
        fresh page replaces them in THIS table only, and the caller (the
        engine) must copy the device page ``old → new``.  Returns the
        ``(old, new)`` pair of such a split, or ``None`` when the page
        was already private (the overwhelmingly common case — decode
        writes land in fresh suffix pages).  May raise
        :class:`OutOfBlocks`; the scheduler's preemption loop handles it
        like any allocation failure."""
        self._accrue()
        table = self._tables[seq_id]
        idx = int(position) // self.block_size
        old = table[idx]
        if self._ref[old] == 1 and old not in self._index_key_of:
            self._last_cow_split = None
            return None
        new = self._pop_page()
        self._release(old)  # registered sole-owner pages park, shared drop a ref
        table[idx] = new
        self._ref[new] = 1
        self._hold(new, self._seq_tenant.get(seq_id))
        self._last_cow_split = (old, new)
        return (old, new)

    # -- read side -----------------------------------------------------
    def __contains__(self, seq_id) -> bool:
        return seq_id in self._tables

    def seq_ids(self):
        return list(self._tables)

    def block_table(self, seq_id) -> List[int]:
        return list(self._tables[seq_id])

    def seq_len(self, seq_id) -> int:
        """Token positions covered by ``seq_id``'s table — the length
        migration snapshots (and restores) a sequence at."""
        return self._lens[seq_id]

    def padded_table(self, seq_id, width: int) -> np.ndarray:
        """The (width,) int32 device view of a table: real page ids then
        the invalid sentinel.  ``width`` is the engine's bucketed
        blocks-per-sequence."""
        table = self._tables[seq_id]
        if len(table) > width:
            raise ValueError(
                f"table of {seq_id!r} has {len(table)} pages > width "
                f"{width}"
            )
        out = np.full((width,), self.invalid, np.int32)
        out[: len(table)] = table
        return out

    @property
    def free_blocks(self) -> int:
        """Reclaimable capacity: truly free plus cached prefix pages."""
        return self._reclaimable()

    @property
    def used_blocks(self) -> int:
        """Pages referenced by at least one live table."""
        return self.n_blocks - self._reclaimable()

    def stats(self) -> CacheStats:
        return CacheStats(
            n_blocks=self.n_blocks,
            block_size=self.block_size,
            used_blocks=self.used_blocks,
            free_blocks=self.free_blocks,
            cached_blocks=self.cached_blocks,
            n_seqs=len(self._tables),
            utilization=self.used_blocks / self.n_blocks,
        )

    # -- invariants ----------------------------------------------------
    def assert_consistent(self) -> None:
        """Conservation check: every page is exactly one of (a) free,
        (b) cached (registered, refcount 0), or (c) referenced by ≥1
        table with a refcount equal to its number of referencing tables;
        every table covers its sequence's length; the prefix index maps
        are mutually inverse and only name live (tabled or cached)
        pages.  Cheap enough for tests to call after every operation."""
        free = set(self._free)
        cached = set(self._cached)
        tabled: Dict[int, int] = {}
        for table in self._tables.values():
            for page in table:
                tabled[page] = tabled.get(page, 0) + 1
        if len(free) != len(self._free):
            raise AssertionError("duplicate pages on the free list")
        if free & cached or free & tabled.keys() or cached & tabled.keys():
            raise AssertionError(
                f"page in two states: free∩cached="
                f"{sorted(free & cached)}, free∩tabled="
                f"{sorted(free & tabled.keys())}, cached∩tabled="
                f"{sorted(cached & tabled.keys())}"
            )
        every = free | cached | tabled.keys()
        if len(every) != self.n_blocks or (
            every and (min(every) < 0 or max(every) >= self.n_blocks)
        ):
            raise AssertionError(
                f"page leak/alias: {len(free)} free + {len(cached)} "
                f"cached + {len(tabled)} tabled != {self.n_blocks} total "
                f"(or out-of-range ids)"
            )
        if self._ref != tabled:
            raise AssertionError(
                f"refcount drift: tracked {self._ref} != actual {tabled}"
            )
        if set(self._page_owner) != set(self._ref):
            raise AssertionError(
                "page-second ownership drift: owners "
                f"{sorted(self._page_owner)} != held {sorted(self._ref)}"
            )
        held: Dict[Optional[str], int] = {}
        for ten in self._page_owner.values():
            held[ten] = held.get(ten, 0) + 1
        if held != {t: c for t, c in self._held.items() if c}:
            raise AssertionError(
                f"per-tenant hold-count drift: {self._held} != {held}"
            )
        for seq_id, table in self._tables.items():
            if len(table) != self.blocks_for(self._lens[seq_id]):
                raise AssertionError(
                    f"table of {seq_id!r} covers {len(table)} pages, "
                    f"length {self._lens[seq_id]} needs "
                    f"{self.blocks_for(self._lens[seq_id])}"
                )
        if self._index_key_of != {
            page: key for key, page in self._index.items()
        } or len(self._index) != len(self._index_key_of):
            raise AssertionError("prefix index maps are not inverse")
        for page in self._index_key_of:
            if page in free:
                raise AssertionError(
                    f"registered page {page} is on the free list"
                )
        for page in cached:
            if page not in self._index_key_of:
                raise AssertionError(
                    f"cached page {page} has no index registration"
                )

    # -- defragmentation ----------------------------------------------
    def defragment(self) -> Optional[np.ndarray]:
        """Compact live pages to indices ``[0, live)``, preserving
        per-sequence page order, and rewrite every table in place — a
        shared page moves exactly once and every referencing table (and
        the prefix index) observes the move.  Cached prefix pages are
        live content and compact right after the tabled region, oldest
        first.

        Returns the (n_blocks,) int32 permutation ``perm`` with
        ``new_pages[i] = old_pages[perm[i]]`` — the engine applies it to
        the device pages as ``pages[perm]`` — or
        ``None`` when the layout is already compact (no device copy
        needed).  Free pages land above the live region in ascending
        order, so a defragmented cache allocates exactly like a fresh
        one."""
        live: List[int] = []
        seen = set()
        for seq_id in sorted(self._tables, key=repr):
            for page in self._tables[seq_id]:
                if page not in seen:
                    seen.add(page)
                    live.append(page)
        for page in self._cached:
            live.append(page)
        if live == list(range(len(live))):
            # Already the dense-prefix layout; just re-seed the free list
            # so future allocations stay dense.  No device copy.
            self._free = list(
                range(self.n_blocks - 1, len(live) - 1, -1)
            )
            self._last_defrag_moves = 0
            return None
        new_of_old = {old: new for new, old in enumerate(live)}
        moves = sum(1 for old, new in new_of_old.items() if old != new)
        leftover = [b for b in range(self.n_blocks) if b not in new_of_old]
        perm = np.asarray(live + leftover, np.int32)
        for table in self._tables.values():
            table[:] = [new_of_old[b] for b in table]
        self._ref = {new_of_old[p]: c for p, c in self._ref.items()}
        self._page_owner = {
            new_of_old[p]: t for p, t in self._page_owner.items()
        }
        self._index = {k: new_of_old[p] for k, p in self._index.items()}
        self._index_key_of = {
            new_of_old[p]: k for p, k in self._index_key_of.items()
        }
        self._cached = OrderedDict(
            (new_of_old[p], None) for p in self._cached
        )
        self._free = list(range(self.n_blocks - 1, len(live) - 1, -1))
        self._last_defrag_moves = moves
        return perm
