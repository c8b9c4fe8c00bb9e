"""The port's ``PagedKVCache`` against the reference's, op for op.

``chainermn_tpu_torch.serving.kv_cache`` is the reference's numpy host
accounting kept as it is.  Two checks:

* the reference's accounting tests (``tests/test_serving.py``), each run
  on both classes;
* hypothesis-drawn op sequences (allocate with and without a prefix hit,
  extend, truncate, free, register / match / adopt prefixes,
  make_writable, defragment, drop the prefix cache) applied to both, with
  the block tables, ``stats().as_dict()``, refcounts, the cached pool, the
  defragment permutations, the per-tenant page-seconds (on one injected
  clock) and every raised exception's type equal after every op, and
  ``assert_consistent()`` passing on both.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from chainermn_tpu.serving import kv_cache as jkv
from chainermn_tpu_torch.serving import kv_cache as tkv

BOTH = pytest.mark.parametrize("m", [jkv, tkv], ids=["reference", "port"])


def test_digests_equal_reference():
    rng = np.random.default_rng(0)
    for n in (0, 3, 16, 33):
        toks = [int(t) for t in rng.integers(0, 50, n)]
        for ns in (None, "tenant-a"):
            assert tkv.prefix_digest(toks, ns) == jkv.prefix_digest(toks, ns)
            assert (tkv.prompt_digests(toks, 4, ns)
                    == jkv.prompt_digests(toks, 4, ns))


@BOTH
def test_kv_cache_alloc_free_conservation(m):
    kv = m.PagedKVCache(n_blocks=8, block_size=4)
    t = kv.allocate("a", 9)
    assert t == [0, 1, 2] and kv.used_blocks == 3
    kv.assert_consistent()
    kv.allocate("b", 4)
    kv.assert_consistent()
    assert kv.free("a") == 3
    kv.assert_consistent()
    assert kv.used_blocks == 1 and "a" not in kv and "b" in kv
    with pytest.raises(KeyError):
        kv.free("a")
    with pytest.raises(ValueError):
        kv.allocate("b", 1)
    kv.free("b")
    assert kv.used_blocks == 0 and kv.stats().utilization == 0.0


@BOTH
def test_kv_cache_extend_and_out_of_blocks(m):
    kv = m.PagedKVCache(n_blocks=4, block_size=4)
    kv.allocate("a", 4)
    assert kv.extend("a", 5) == [1]
    assert kv.extend("a", 8) == []
    kv.assert_consistent()
    kv.allocate("b", 8)
    with pytest.raises(m.OutOfBlocks):
        kv.extend("a", 9)
    with pytest.raises(m.OutOfBlocks):
        kv.allocate("c", 1)
    kv.assert_consistent()
    assert not kv.can_allocate(1)
    kv.free("b")
    assert kv.can_allocate(8) and not kv.can_allocate(8, reserve=1)


@BOTH
def test_kv_cache_padded_table_uses_oob_sentinel(m):
    kv = m.PagedKVCache(n_blocks=8, block_size=4)
    kv.allocate("a", 5)
    t = kv.padded_table("a", 4)
    assert t.dtype == np.int32
    assert list(t) == [0, 1, kv.invalid, kv.invalid]
    assert kv.invalid == 8
    with pytest.raises(ValueError):
        kv.padded_table("a", 1)


@BOTH
def test_kv_prefix_share_refcounts_and_cow_split(m):
    kv = m.PagedKVCache(n_blocks=8, block_size=4)
    toks = list(range(10))
    kv.allocate("a", 10)
    assert kv.match_prefix(toks) == []
    assert kv.register_prefix("a", toks) == 2
    hit = kv.match_prefix(toks)
    assert hit == kv.block_table("a")[:2]
    before = kv.free_blocks
    kv.allocate("b", 10, prefix_pages=hit)
    assert kv.block_table("b")[:2] == hit
    assert before - kv.free_blocks == 1
    assert kv.refcount(hit[0]) == 2
    kv.assert_consistent()
    old, new = kv.make_writable("b", 4)
    assert old == hit[1] and kv.block_table("b")[1] == new
    assert kv.refcount(old) == 1 and kv.refcount(new) == 1
    assert kv.block_table("a")[1] == old
    assert kv.match_prefix(toks) == hit
    assert kv.make_writable("b", 9) is None
    kv.assert_consistent()


@BOTH
def test_kv_evict_one_of_two_sharers(m):
    kv = m.PagedKVCache(n_blocks=8, block_size=4)
    toks = list(range(8))
    kv.allocate("a", 8)
    kv.register_prefix("a", toks)
    shared = kv.match_prefix(toks)
    kv.allocate("b", 8, prefix_pages=shared)
    kv.free("a")
    kv.assert_consistent()
    assert [kv.refcount(p) for p in shared] == [1, 1]
    assert kv.match_prefix(toks) == shared
    kv.free("b")
    kv.assert_consistent()
    assert kv.cached_blocks == 2
    assert kv.match_prefix(toks) == shared
    kv.allocate("c", 8, prefix_pages=kv.match_prefix(toks))
    assert kv.cached_blocks == 0 and kv.block_table("c") == shared
    kv.assert_consistent()


@BOTH
def test_kv_cached_pool_lru_eviction_under_pressure(m):
    kv = m.PagedKVCache(n_blocks=4, block_size=4)
    kv.allocate("a", 8)
    kv.register_prefix("a", list(range(8)))
    kv.free("a")
    assert kv.cached_blocks == 2
    assert kv.free_blocks == 4
    kv.allocate("b", 12)
    kv.assert_consistent()
    assert kv.cached_blocks == 1
    assert len(kv.match_prefix(list(range(8)))) <= 1
    with pytest.raises(m.OutOfBlocks):
        kv.allocate("c", 8)
    kv.assert_consistent()


@BOTH
def test_kv_defragment_while_shared(m):
    kv = m.PagedKVCache(n_blocks=8, block_size=4)
    toks = list(range(8))
    kv.allocate("a", 8)
    kv.register_prefix("a", toks)
    kv.allocate("hole", 8)
    kv.allocate("b", 10, prefix_pages=kv.match_prefix(toks))
    kv.free("hole")
    shared_before = kv.match_prefix(toks)
    perm = kv.defragment()
    kv.assert_consistent()
    assert perm is not None
    shared_after = kv.match_prefix(toks)
    assert kv.block_table("a")[:2] == shared_after
    assert kv.block_table("b")[:2] == shared_after
    assert [kv.refcount(p) for p in shared_after] == [2, 2]
    assert [perm[p] for p in shared_after] == shared_before
    kv.free("a")
    kv.free("b")
    assert kv.cached_blocks == 2
    assert kv.defragment() is None or kv.match_prefix(toks)
    kv.assert_consistent()


@BOTH
def test_kv_cache_defragment_permutation_semantics(m):
    kv = m.PagedKVCache(n_blocks=8, block_size=4)
    kv.allocate("a", 8)
    kv.allocate("b", 8)
    kv.free("a")
    pages = np.arange(8)
    old_table = kv.block_table("b")
    perm = kv.defragment()
    kv.assert_consistent()
    new_pages = pages[perm]
    assert [new_pages[i] for i in kv.block_table("b")] == old_table
    assert kv.block_table("b") == [0, 1]
    assert kv.defragment() is None
    assert kv.allocate("c", 4) == [2]


@BOTH
def test_kv_page_seconds_conservation(m):
    t = [0.0]
    kv = m.PagedKVCache(n_blocks=16, block_size=4, clock=lambda: t[0])
    kv.allocate("a", 8, tenant="ta")
    t[0] = 5.0
    kv.allocate("b", 4, tenant="tb")
    t[0] = 7.0
    kv.extend("a", 12)
    t[0] = 10.0
    assert kv.page_seconds() == {"ta": pytest.approx(23.0),
                                 "tb": pytest.approx(5.0)}
    assert kv.pool_page_seconds() == pytest.approx(28.0)
    toks = list(range(12))
    kv.register_prefix("a", toks)
    shared = kv.match_prefix(toks)
    kv.allocate("c", 14, prefix_pages=shared, tenant="tb")
    t[0] = 12.0
    ps = kv.page_seconds()
    assert ps == {"ta": pytest.approx(29.0), "tb": pytest.approx(9.0)}
    kv.allocate("d", 4)
    t[0] = 14.0
    ps = kv.page_seconds()
    assert kv.pool_page_seconds() == pytest.approx(sum(ps.values()) + 2.0)
    kv.free("a")
    kv.free("d")
    kv.defragment()
    t[0] = 18.0
    kv.truncate("c", 12)
    t[0] = 20.0
    assert kv.page_seconds() == {"ta": pytest.approx(53.0),
                                 "tb": pytest.approx(23.0)}
    kv.free("b")
    kv.free("c")
    t[0] = 100.0
    assert kv.pool_page_seconds() == pytest.approx(53.0 + 23.0 + 2.0)
    kv.assert_consistent()


# ---------------------------------------------------------------------------
# Op sequences: both classes driven in lockstep
# ---------------------------------------------------------------------------
SEQS = ("s0", "s1", "s2", "s3")
_tokens = st.lists(st.integers(0, 2), min_size=1, max_size=14)
_op = st.one_of(
    st.tuples(st.just("alloc"), st.sampled_from(SEQS), _tokens,
              st.booleans(), st.sampled_from([None, "ta", "tb"])),
    st.tuples(st.just("extend"), st.sampled_from(SEQS), st.integers(0, 9)),
    st.tuples(st.just("truncate"), st.sampled_from(SEQS), st.integers(0, 9)),
    st.tuples(st.just("free"), st.sampled_from(SEQS)),
    st.tuples(st.just("register"), st.sampled_from(SEQS)),
    st.tuples(st.just("adopt"), st.sampled_from(SEQS), st.integers(0, 2)),
    st.tuples(st.just("cow"), st.sampled_from(SEQS), st.integers(0, 20)),
    st.tuples(st.just("defrag")),
    st.tuples(st.just("drop")),
)


def _apply(kv, toks, op):
    """One op on ``kv`` (``toks``: each live sequence's token ids).
    Returns the op's result or the type name of what it raised."""
    kind, *a = op
    try:
        if kind == "alloc":
            sid, tokens, hit, tenant = a
            prefix = kv.match_prefix(tokens) if hit else None
            if prefix and len(prefix) * kv.block_size >= len(tokens):
                prefix = prefix[:-1]
            out = kv.allocate(sid, len(tokens), prefix_pages=prefix,
                              tenant=tenant)
            toks[sid] = list(tokens)
            return out
        if kind == "extend":
            sid, extra = a
            return kv.extend(sid, kv.seq_len(sid) + extra)
        if kind == "truncate":
            sid, n = a
            return kv.truncate(sid, min(n, kv.seq_len(sid)))
        if kind == "free":
            toks.pop(a[0], None)
            return kv.free(a[0])
        if kind == "register":
            return kv.register_prefix(a[0], toks[a[0]])
        if kind == "adopt":
            sid, start = a
            pages = kv.match_prefix(toks[sid])
            pages = pages[:len(kv.block_table(sid))]
            return kv.adopt_prefix(sid, pages, start_idx=start)
        if kind == "cow":
            sid, pos = a
            return kv.make_writable(sid, min(pos, max(kv.seq_len(sid) - 1,
                                                      0)))
        if kind == "defrag":
            perm = kv.defragment()
            return None if perm is None else [int(p) for p in perm]
        return kv.drop_prefix_cache()
    except Exception as e:  # the same failure on both sides
        return type(e).__name__


def _state(kv):
    return dict(
        tables={s: kv.block_table(s) for s in kv.seq_ids()},
        lens={s: kv.seq_len(s) for s in kv.seq_ids()},
        stats=kv.stats().as_dict(),
        refs=dict(kv._ref),
        cached=list(kv._cached),
        free=list(kv._free),
        index=dict(kv._index),
        version=kv.index_version,
        digests=kv.prefix_digests(),
        page_seconds=kv.page_seconds(),
        pool=kv.pool_page_seconds(),
    )


@settings(max_examples=60, deadline=None)
@given(ops=st.lists(_op, min_size=1, max_size=40),
       n_blocks=st.integers(4, 12), prefix_cache=st.booleans())
def test_op_sequences_match_reference(ops, n_blocks, prefix_cache):
    clocks = [[0.0], [0.0]]
    ref = jkv.PagedKVCache(n_blocks, 4, prefix_cache=prefix_cache,
                           clock=lambda: clocks[0][0])
    port = tkv.PagedKVCache(n_blocks, 4, prefix_cache=prefix_cache,
                            clock=lambda: clocks[1][0])
    rtoks, ptoks = {}, {}
    for i, op in enumerate(ops):
        clocks[0][0] = clocks[1][0] = float(i)
        r = _apply(ref, rtoks, op)
        p = _apply(port, ptoks, op)
        assert p == r, (op, p, r)
        ref.assert_consistent()
        port.assert_consistent()
        assert _state(port) == _state(ref), op
