"""The port's in-process serving cluster (router, replicas, migration,
disaggregation, gossip, health, threaded driver) against the JAX
package, on the CPU.

The in-process cases of ``tests/test_serving_cluster.py``, each stream
held to the reference engine's on the same prompts and seeds (a tiny
fp32 ``TransformerLM``: vocab 32, d_model 16, 2 heads, 2 layers, the
reference's flax init converted into the port).  The KV snapshot crosses
the port's object plane at 2 gloo ranks (``tests/_torch_serve_worker.py``)
with bf16, fp32 and int8 pages, bitwise.

Left for the multi-process tier: the socket-plane round trip
(``kvtransport``), shard groups (``plan_groups``), the Prometheus labels
(``tools.obs``), the ``tools/serve`` CLI and the bench smoke.
"""

import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_serve_worker as worker
from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.serving import engine as jengine
from chainermn_tpu_torch import convert
from chainermn_tpu_torch.models.transformer import TransformerLM
from chainermn_tpu_torch.observability import Reporter
from chainermn_tpu_torch.serving import (
    ContinuousBatchingScheduler,
    EngineConfig,
    InferenceEngine,
    OutOfBlocks,
    PagedKVCache,
    QueueFull,
    Request,
    SamplingParams,
    ServeFrontend,
    prefix_digest,
    prompt_digests,
)
from chainermn_tpu_torch.serving.cluster import (
    HeartbeatMonitor,
    KVSnapshot,
    MetricsGossip,
    PrefixGossip,
    Replica,
    ReplicaLoad,
    ReplicaRouter,
    ScaleSignalFilter,
    ThreadedClusterDriver,
    extract_sequence,
    recv_snapshot,
    restore_sequence,
    scale_signals,
    send_snapshot,
)
from chainermn_tpu_torch.serving.cluster.disagg import (
    PrefillJob,
    run_prefill_job,
)

VOCAB = 32
CFG = dict(vocab=VOCAB, d_model=16, n_heads=2, d_ff=32, n_layers=2,
           max_len=64)


@pytest.fixture(scope="module")
def ref():
    jlm = JaxLM(**CFG, dtype=jnp.float32)
    params = jlm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jlm, params


@pytest.fixture(scope="module")
def lm(ref):
    m = TransformerLM(**CFG, dtype=torch.float32, device="cpu")
    m.load_state_dict(convert.flax_to_state_dict(jax.device_get(ref[1])))
    return m


@pytest.fixture(scope="module")
def oracle_streams(ref):
    """The reference engine's sequential streams (fp32; a few pinned
    buckets so XLA compiles few programs), memoised by prompt."""
    eng = jengine.InferenceEngine(ref[0], ref[1], jengine.EngineConfig(
        block_size=4, n_blocks=64, max_len=64, max_batch=4,
        prefill_buckets=(16, 32), batch_buckets=(1, 4),
        table_width_buckets=(16,), chunk_buckets=(8,)))
    memo = {}

    def run(prompts, n, sampling=None):
        out = []
        for p in prompts:
            key = (tuple(p), n, sampling)
            if key not in memo:
                sp = (jengine.SamplingParams() if sampling is None
                      else jengine.SamplingParams(**dict(sampling)))
                memo[key] = eng.generate(list(p), n, sampling=sp)
            out.append(list(memo[key]))
        return out

    return run


def make_engine(lm, **over):
    cfg = dict(block_size=4, n_blocks=64, max_len=64, max_batch=4)
    cfg.update(over)
    return InferenceEngine(lm, EngineConfig(**cfg), device="cpu")


def prompts_for(n, rng_seed=7, lo=3, hi=13):
    rng = np.random.default_rng(rng_seed)
    return [[int(t) for t in rng.integers(0, VOCAB, size=int(n_))]
            for n_ in rng.integers(lo, hi, size=n)]


def _mk_cluster(lm, n=2, roles=None, **router_kw):
    reps = [Replica(i, make_engine(lm),
                    role=(roles[i] if roles else "both"),
                    max_queue=router_kw.pop(f"_q{i}", 8))
            for i in range(n)]
    return reps, ReplicaRouter(reps, **router_kw)


# ---------------------------------------------------------------------------
# Unit seams: seq_len, adopt_request, retry-after hint
# ---------------------------------------------------------------------------


def test_kv_seq_len_tracks_allocation(lm):
    eng = make_engine(lm)
    eng.kv.allocate("s", 6)
    assert eng.kv.seq_len("s") == 6
    eng.kv.extend("s", 9)
    assert eng.kv.seq_len("s") == 9
    eng.kv.free("s")
    with pytest.raises(KeyError):
        eng.kv.seq_len("s")


def test_adopt_request_validates_cache_state(lm):
    eng = make_engine(lm)
    sched = ContinuousBatchingScheduler(eng)
    req = Request(request_id="r", prompt=[1, 2, 3], max_new_tokens=4)
    req.generated = [5]
    with pytest.raises(ValueError):
        sched.adopt_request(req)
    eng.kv.allocate("r", 2)
    with pytest.raises(ValueError):
        sched.adopt_request(req)
    eng.kv.extend("r", len(req.context) - 1)
    sched.adopt_request(req)
    assert req in sched.running
    for i in range(eng.max_batch - 1):
        sched.running.append(
            Request(request_id=i, prompt=[1], max_new_tokens=1))
    r2 = Request(request_id="r2", prompt=[1, 2], max_new_tokens=4)
    eng.kv.allocate("r2", 1)
    with pytest.raises(OutOfBlocks):
        sched.adopt_request(r2)


def test_adopted_request_stream_is_bit_exact(lm, oracle_streams):
    prompt = prompts_for(1)[0]
    [want] = oracle_streams([prompt], 6)
    eng = make_engine(lm)
    sched = ContinuousBatchingScheduler(eng)
    req = Request(request_id="a", prompt=prompt, max_new_tokens=6)
    eng.kv.allocate("a", len(prompt))
    logits = eng.prefill(prompt, "a")
    req.generated = [eng.sample(logits, req.sampling, len(prompt))]
    sched.adopt_request(req)
    sched.run_to_completion()
    assert req.generated == want


def test_frontend_retry_after_hint_from_throughput(lm):
    fe = ServeFrontend(ContinuousBatchingScheduler(make_engine(lm)),
                       max_queue=2)
    p = prompts_for(1)[0]
    fe.submit(p, 8)
    fe.submit(p, 8)
    with pytest.raises(QueueFull) as e1:
        fe.submit(p, 8)
    assert e1.value.retry_after_s is None
    assert fe.decode_tokens_per_sec() is None
    for _ in range(4):
        fe.step()
    assert fe.decode_tokens_per_sec() > 0
    fe.submit(p, 8)
    fe.submit(p, 8)
    with pytest.raises(QueueFull) as e2:
        fe.submit(p, 8)
    assert e2.value.retry_after_s > 0
    assert "retry after" in str(e2.value)
    fe.run_until_idle()


# ---------------------------------------------------------------------------
# Router: load-aware placement, parity, backpressure, failover
# ---------------------------------------------------------------------------


def test_router_parity_and_load_spread(lm, oracle_streams):
    prompts = prompts_for(6, rng_seed=3)
    want = oracle_streams(prompts, 8)
    reps, router = _mk_cluster(lm, n=2)
    handles = [router.submit(p, 8) for p in prompts]
    router.run_until_idle()
    for h, w in zip(handles, want):
        assert h.status == "finished"
        assert router.result(h) == w
    assert {h.replica_id for h in handles} == {0, 1}
    for r in reps:
        r.engine.kv.assert_consistent()


def test_router_respects_draining_and_roles(lm):
    reps, router = _mk_cluster(lm, n=2)
    router.drain(0)
    h = router.submit(prompts_for(1)[0], 4)
    router.run_until_idle()
    assert h.replica_id == 1
    reps2, router2 = _mk_cluster(lm, n=2, roles=["prefill", "both"])
    h2 = router2.submit(prompts_for(1)[0], 4)
    router2.run_until_idle()
    assert h2.replica_id == 1


def test_router_queue_full_propagates_min_hint(lm):
    reps = [Replica(0, make_engine(lm, max_batch=1), max_queue=1)]
    router = ReplicaRouter(reps)
    p = prompts_for(1)[0]
    router.submit(p, 8)
    with pytest.raises(QueueFull):
        router.submit(p, 8)
    router.run_until_idle()


def test_router_failover_is_bit_exact(lm, oracle_streams):
    prompts = prompts_for(6, rng_seed=11, lo=4, hi=10)
    want = oracle_streams(prompts, 8)
    reps, router = _mk_cluster(
        lm, n=2, health=HeartbeatMonitor([0, 1], miss_after_s=1e9))
    handles = [router.submit(p, 8) for p in prompts]
    for _ in range(3):
        router.step()
    victim = next(h.replica_id for h in handles if not h.done)
    survivor = 1 - victim
    assert router.fail_replica(victim, "test kill") > 0
    router.run_until_idle()
    for h, w in zip(handles, want):
        assert h.status == "finished"
        assert h.tokens == w
    assert any(h.failovers == 1 for h in handles)
    assert all(h.replica_id == survivor for h in handles if h.failovers)
    reps[survivor].engine.kv.assert_consistent()


def test_cluster_handle_timeout_and_result(lm):
    clock = [0.0]
    reps = [Replica(0, make_engine(lm), clock=lambda: clock[0])]
    router = ReplicaRouter(reps, clock=lambda: clock[0])
    h = router.submit(prompts_for(1)[0], 8, timeout_s=5.0)
    router.step()
    clock[0] = 10.0
    router.step()
    assert h.status == "timeout"
    with pytest.raises(TimeoutError):
        router.result(h)


# ---------------------------------------------------------------------------
# Migration: extract/restore, the object-plane round trip
# ---------------------------------------------------------------------------


def test_migration_mid_stream_is_bit_exact(lm, oracle_streams):
    prompt = prompts_for(1, rng_seed=5)[0]
    [want] = oracle_streams([prompt], 8)
    src = make_engine(lm)
    dst = make_engine(lm, n_blocks=32)
    sp = SamplingParams()
    src.kv.allocate("s", len(prompt))
    logits = src.prefill(prompt, "s")
    toks = [src.sample(logits, sp, len(prompt))]
    cur = len(prompt)
    for _ in range(3):
        src.kv.extend("s", cur + 1)
        logits = src.decode([toks[-1]], ["s"], [cur])[0]
        cur += 1
        toks.append(src.sample(logits, sp, cur))
    snap = extract_sequence(src, "s", context=prompt + toks[:-1])
    assert snap.seq_len == cur and snap.n_pages > 0
    src.kv.free("s")
    src.kv.assert_consistent()
    restore_sequence(dst, snap, "t")
    dst.kv.assert_consistent()
    while len(toks) < 8:
        dst.kv.extend("t", cur + 1)
        logits = dst.decode([toks[-1]], ["t"], [cur])[0]
        cur += 1
        toks.append(dst.sample(logits, sp, cur))
    assert toks == want


def test_restore_rejects_mismatched_geometry(lm):
    src = make_engine(lm)
    src.kv.allocate("s", 5)
    src.prefill([1, 2, 3, 4, 5], "s")
    snap = extract_sequence(src, "s")
    bad = make_engine(lm, block_size=8, n_blocks=32)
    with pytest.raises(ValueError):
        restore_sequence(bad, snap, "t")
    bad.kv.assert_consistent()
    # int8 pages carry four leaves a layer, and other dtypes
    q = make_engine(lm, kv_dtype="int8")
    with pytest.raises(ValueError, match="structure"):
        restore_sequence(q, snap, "t")
    snap.dtypes = ["bfloat16"] * len(snap.pages)
    with pytest.raises(ValueError, match="dtype"):
        restore_sequence(make_engine(lm), snap, "t")
    q.kv.assert_consistent()


class _QueuePlane:
    """An in-process object plane of the reference ``ObjectPlane``'s
    shape (``send(obj, dest, tag)``, ``recv(src, tag, timeout_ms)``)."""

    def __init__(self):
        self.frames = []

    def send(self, obj, dest, tag=0):
        self.frames.append((dest, tag, obj))

    def recv(self, src, tag=0, timeout_ms=None):
        return self.frames.pop(0)[2]


@pytest.mark.parametrize("dtype,kv", [(torch.float32, None),
                                      (torch.bfloat16, None),
                                      (torch.float32, "int8")],
                         ids=["fp32", "bf16", "int8"])
def test_snapshot_roundtrip_in_process_bitwise(ref, dtype, kv):
    """extract -> send_snapshot -> recv_snapshot -> restore into a second
    engine: the pages bitwise equal (bf16 as uint16 bits), the int8
    scales too, and the continued stream equals the uninterrupted one."""
    m = TransformerLM(**CFG, dtype=dtype, device="cpu")
    m.load_state_dict(convert.flax_to_state_dict(jax.device_get(ref[1])))
    src, dst = make_engine(m, kv_dtype=kv), make_engine(m, kv_dtype=kv)
    prompt = prompts_for(1, rng_seed=5)[0]
    whole = src.generate(prompt, 6)
    src.kv.allocate("s", len(prompt))
    toks = [int(np.argmax(src.prefill(prompt, "s")))]
    cur = len(prompt)
    for _ in range(2):
        src.kv.extend("s", cur + 1)
        toks.append(int(np.argmax(src.decode([toks[-1]], ["s"],
                                             [cur])[0])))
        cur += 1
    snap = extract_sequence(src, "s", context=prompt + toks[:-1],
                            prompt_len=len(prompt))
    assert len(snap.pages) == 2 * CFG["n_layers"] * (2 if kv else 1)
    want_dt = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    assert snap.dtypes[0] == ("int8" if kv else want_dt)
    plane = _QueuePlane()
    send_snapshot(plane, 1, snap)
    got = recv_snapshot(plane, 0)
    assert got.context == snap.context and got.dtypes == snap.dtypes
    restore_sequence(dst, got, "t")
    back = extract_sequence(dst, "t")
    for a, b in zip(snap.pages, back.pages):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for _ in range(3):
        dst.kv.extend("t", cur + 1)
        toks.append(int(np.argmax(dst.decode([toks[-1]], ["t"],
                                             [cur])[0])))
        cur += 1
    assert toks == whole
    dst.kv.assert_consistent()


def test_snapshot_object_plane_roundtrip_two_ranks(tmp_path, ref):
    """The same round trip across two gloo ranks through the port's
    communicator object plane (``send_obj``/``recv_obj``): bf16, fp32 and
    int8 pages arrive byte for byte, restore bitwise, and the stream
    continued on rank 1 equals the uninterrupted one."""
    sd = convert.flax_to_state_dict(jax.device_get(ref[1]))
    np.savez(tmp_path / "init.npz", **{k: v.numpy() for k, v in sd.items()})
    res = worker.spawn("snapshot", 2, tmp_path, lm=CFG,
                       prompt=prompts_for(1, rng_seed=5)[0])
    out = res[1]
    for name in ("fp32", "bf16", "int8"):
        assert out[f"{name}_wire_equal"] and out[f"{name}_pages_equal"]
        assert out[f"{name}_stream"] == out[f"{name}_whole"], name
    assert out["bf16_dtypes"][0] == "bfloat16"
    assert out["int8_dtypes"][:4] == ["int8", "int8", "float32", "float32"]


# ---------------------------------------------------------------------------
# Disaggregation
# ---------------------------------------------------------------------------


def test_disagg_prefill_decode_split(lm, oracle_streams):
    long_prompt = prompts_for(1, rng_seed=9, lo=24, hi=25)[0]
    short = prompts_for(3, rng_seed=10, lo=3, hi=6)
    want = oracle_streams([long_prompt] + short, 8)
    reps, router = _mk_cluster(lm, n=2, roles=["prefill", "decode"],
                               prefill_threshold=10)
    handles = [router.submit(long_prompt, 8)]
    handles += [router.submit(p, 8) for p in short]
    router.run_until_idle()
    for h, w in zip(handles, want):
        assert h.status == "finished"
        assert h.tokens == w
    assert handles[0].replica_id == 1
    assert reps[0].engine._tokens_decoded == 0
    assert all(h.replica_id == 1 for h in handles[1:])
    for r in reps:
        r.engine.kv.assert_consistent()


def test_disagg_requeues_when_prompt_cannot_fit(lm):
    eng = make_engine(lm, n_blocks=4)
    res = run_prefill_job(eng, PrefillJob(
        handle=0, prompt=list(range(1, 30)), sampling=SamplingParams()))
    assert res is not None and res.error is not None
    eng2 = make_engine(lm, n_blocks=4)
    eng2.kv.allocate("hog", 12)
    out = run_prefill_job(eng2, PrefillJob(
        handle=1, prompt=list(range(1, 9)), sampling=SamplingParams()))
    assert out is None
    eng2.kv.free("hog")
    out = run_prefill_job(eng2, PrefillJob(
        handle=1, prompt=list(range(1, 9)), sampling=SamplingParams()))
    assert out is not None and out.error is None
    assert out.snapshot.n_pages == 2
    eng2.kv.assert_consistent()


# ---------------------------------------------------------------------------
# Cluster-global prefix index (gossip)
# ---------------------------------------------------------------------------


def test_prefix_digest_content_addressed_and_defrag_stable():
    from chainermn_tpu.serving import prefix_digest as jax_digest

    toks = list(range(12))
    d1 = prefix_digest(toks)
    assert d1 == jax_digest(toks)
    assert d1 == prefix_digest(tuple(toks))
    assert d1 == prefix_digest(np.asarray(toks, np.int32))
    assert d1 != prefix_digest(toks[:-1])
    assert prompt_digests(toks, 4) == [
        prefix_digest(toks[:4]), prefix_digest(toks[:8]),
        prefix_digest(toks)]
    assert prompt_digests(toks[:3], 4) == []
    kv = PagedKVCache(16, 4)
    kv.allocate("a", 12)
    kv.register_prefix("a", toks)
    before = kv.prefix_digests()
    kv.free("a")
    kv.defragment()
    assert kv.prefix_digests() == before
    assert kv.match_prefix(toks)


def test_prefix_digest_tenant_salt_isolates_namespaces():
    from chainermn_tpu.serving import prefix_digest as jax_digest

    toks = list(range(12))
    assert prefix_digest(toks) == prefix_digest(toks, namespace=None)
    da, db = prefix_digest(toks, "ta"), prefix_digest(toks, "tb")
    assert da == jax_digest(toks, "ta")
    assert len({prefix_digest(toks), da, db}) == 3
    assert prompt_digests(toks, 4, namespace="ta") == [
        prefix_digest(toks[:4], "ta"), prefix_digest(toks[:8], "ta"), da]
    kv = PagedKVCache(16, 4)
    kv.allocate("a", 12)
    kv.register_prefix("a", toks, namespace="ta")
    assert kv.match_prefix(toks, namespace="ta")
    assert kv.match_prefix(toks, namespace="tb") == []
    assert kv.match_prefix(toks) == []
    assert da in kv.prefix_digests()


def test_request_prefix_namespace_follows_tenant_unless_shared():
    r = Request(request_id="r", prompt=[1], max_new_tokens=1, tenant="ta")
    assert r.prefix_namespace == "ta"
    s = Request(request_id="s", prompt=[1], max_new_tokens=1, tenant="ta",
                shared_prefix=True)
    assert s.prefix_namespace is None
    t = Request(request_id="t", prompt=[1], max_new_tokens=1)
    assert t.prefix_namespace is None


def test_scheduler_tenant_prefix_isolation_and_shared_optin(
        lm, oracle_streams):
    prompt = [int(t) for t in
              np.random.default_rng(3).integers(0, VOCAB, size=9)]
    want = oracle_streams([prompt], 5)[0]

    def run(shared):
        eng = make_engine(lm)
        sched = ContinuousBatchingScheduler(eng)
        for i, ten in enumerate(("ta", "tb")):
            sched.add_request(Request(
                request_id=f"r{i}", prompt=list(prompt), max_new_tokens=5,
                tenant=ten, shared_prefix=shared))
            while sched.has_work:
                sched.step()
        assert [r.generated for r in sched.results().values()] \
            == [want, want]
        return eng._tokens_prefix_cached

    assert run(shared=False) == 0
    assert run(shared=True) > 0


def test_engine_mirror_replay_lockstep_parity(lm):
    """A follower replaying the leader's mirrored device steps (prefill,
    decode, chunk, cow, defrag) ends with bit-identical pages."""
    leader, follower = make_engine(lm), make_engine(lm)
    ops = []
    leader.mirror_sink = lambda op, payload: ops.append((op, payload))
    rng = np.random.default_rng(11)
    shared = [int(t) for t in rng.integers(0, VOCAB, size=8)]
    sched = ContinuousBatchingScheduler(leader)
    for i in range(3):
        tail = ([int(t) for t in rng.integers(0, VOCAB, size=3 + i)]
                if i < 2 else [])
        sched.add_request(Request(
            request_id=f"r{i}", prompt=shared + tail, max_new_tokens=6,
            sampling=(SamplingParams() if i % 2 == 0 else
                      SamplingParams(temperature=0.9, top_k=8,
                                     seed=100 + i))))
        while sched.has_work:
            sched.step()
    leader.defragment()
    leader.kv.allocate("x", 8)
    leader.kv.allocate("y", 8)
    leader.kv.free("x")
    assert leader.defragment() > 0
    assert {op for op, _ in ops} >= {"prefill", "decode", "chunk", "cow",
                                     "defrag"}
    for op, payload in ops:
        follower.apply_step(op, payload)
    for a, b in zip(leader._cache, follower._cache):
        for x, y in zip(a.leaves().values(), b.leaves().values()):
            assert torch.equal(x, y)
    with pytest.raises(ValueError):
        follower.apply_step("nonsense", ())


def test_prefix_gossip_versioned_anti_entropy():
    g = PrefixGossip()
    assert g.observe("B", 2, (10, 20, 30))
    assert not g.observe("B", 2, (10, 20, 30))
    assert not g.observe("B", 1, (99,))
    assert g.hit_pages([10, 20, 30], "B") == 3
    assert g.hit_pages([10, 99, 30], "B") == 1
    assert g.hit_pages([99, 20], "B") == 0
    assert g.observe("B", 5, (10,))
    assert g.hit_pages([10, 20], "B") == 1
    assert g.best([10]) == ("B", 1)
    g.forget("B")
    assert g.hit_pages([10], "B") == 0 and g.replicas() == []


def test_kv_index_version_bumps_on_mutation(lm):
    engine = make_engine(lm)
    v0 = engine.kv.index_version
    engine.generate(prompts_for(1, rng_seed=2, lo=8, hi=9)[0], 2)
    kv = engine.kv
    kv.allocate("w", 8)
    kv.register_prefix("w", list(range(8)))
    assert kv.index_version > v0
    v1 = kv.index_version
    kv.free("w")
    kv.drop_prefix_cache()
    assert kv.index_version > v1


def test_router_gossip_routes_to_warm_replica(lm, oracle_streams):
    template = prompts_for(1, rng_seed=41, lo=12, hi=13)[0]
    reps, router = _mk_cluster(lm, n=3)
    h0 = router.submit(list(template), 4)
    router.run_until_idle()
    warm = h0.replica_id
    router.step()
    dig = prompt_digests(template, 4)
    assert router.gossip.hit_pages(dig, warm) >= 3
    tails = prompts_for(3, rng_seed=43, lo=4, hi=8)
    handles = [router.submit(template + t, 4) for t in tails]
    router.run_until_idle()
    want = oracle_streams([template + t for t in tails], 4)
    for h, w in zip(handles, want):
        assert h.status == "finished" and h.tokens == w
        assert h.replica_id == warm
    for r in reps:
        r.engine.kv.assert_consistent()


def test_stale_gossip_falls_back_to_local_prefill(lm, oracle_streams):
    template = prompts_for(1, rng_seed=41, lo=12, hi=13)[0]
    reps, router = _mk_cluster(lm, n=2)
    h0 = router.submit(list(template), 4)
    router.run_until_idle()
    warm = h0.replica_id
    router.step()
    reps[warm].engine.kv.drop_prefix_cache()
    prompt = template + prompts_for(1, rng_seed=47, lo=4, hi=5)[0]
    h = router.submit(list(prompt), 4)
    router.run_until_idle()
    want = oracle_streams([prompt], 4)[0]
    assert h.status == "finished" and h.tokens == want
    assert h.replica_id == warm
    assert reps[warm].scheduler._prefix_hit_tokens == 0
    reps[warm].engine.kv.assert_consistent()
    router.step()
    kv = reps[warm].engine.kv
    assert router.gossip.version(warm) == kv.index_version
    assert router.gossip.hit_pages(prompt_digests(template, 4), warm) \
        == len(kv.match_prefix(template)) == 3


def test_replica_load_gossip_fields_roundtrip(lm):
    rep = Replica(0, make_engine(lm))
    rep.frontend.submit(prompts_for(1, rng_seed=41, lo=12, hi=13)[0], 2)
    while rep.scheduler.has_work:
        rep.step()
    ld = rep.load()
    assert ld.block_size == 4 and ld.prefix_version > 0
    assert len(ld.prefix_digests) > 0
    assert ReplicaLoad.from_dict(ld.as_dict()) == ld
    old = {k: v for k, v in ld.as_dict().items()
           if k not in ("block_size", "prefix_version", "prefix_digests")}
    ld_old = ReplicaLoad.from_dict(old)
    assert ld_old.block_size == 0 and ld_old.prefix_digests == ()


def test_replica_load_max_bucket_roundtrip(lm):
    rep = Replica(0, make_engine(lm, prefill_buckets=(8,)))
    prompt = prompts_for(1, rng_seed=71, lo=20, hi=21)[0]
    rep.frontend.submit(list(prompt), 2)
    while rep.scheduler.has_work:
        rep.step()
    ld = rep.load()
    assert ld.max_bucket >= len(prompt)
    assert ReplicaLoad.from_dict(ld.as_dict()) == ld
    old = {k: v for k, v in ld.as_dict().items() if k != "max_bucket"}
    assert ReplicaLoad.from_dict(old).max_bucket == 0


def test_router_warm_ladder_routes_long_prompts(lm, oracle_streams):
    reps = [Replica(i, make_engine(lm, prefill_buckets=(8,)))
            for i in range(2)]
    router = ReplicaRouter(reps)
    long0 = prompts_for(1, rng_seed=73, lo=20, hi=21)[0]
    reps[0].frontend.submit(list(long0), 2)
    while reps[0].scheduler.has_work:
        reps[0].step()
    assert reps[0].engine.max_bucket >= len(long0)
    reps[0].engine.kv.drop_prefix_cache()
    router.step()
    prompt = prompts_for(1, rng_seed=79, lo=12, hi=13)[0]
    assert len(prompt) > 8
    h = router.submit(list(prompt), 4)
    router.run_until_idle()
    want = oracle_streams([prompt], 4)[0]
    assert h.status == "finished" and h.tokens == want
    assert h.replica_id == 0
    for r in reps:
        r.engine.kv.assert_consistent()


# ---------------------------------------------------------------------------
# Health: heartbeats, scale signals, the hysteresis filter, gauges
# ---------------------------------------------------------------------------


def test_heartbeat_monitor_detects_and_revives():
    clock = [0.0]
    mon = HeartbeatMonitor([0, 1], miss_after_s=2.0, clock=lambda: clock[0])
    mon.beat(0)
    mon.beat(1)
    clock[0] = 1.0
    assert mon.check() == []
    clock[0] = 2.5
    mon.beat(1)
    assert mon.check() == [0]
    assert mon.check() == []
    assert not mon.alive(0) and mon.alive(1)
    mon.beat(0)
    assert mon.alive(0)
    clock[0] = 3.0
    assert mon.check() == []


def test_filebeat_and_read_beat(tmp_path):
    from chainermn_tpu_torch.elastic import BeatInfo, FileBeat
    from chainermn_tpu_torch.elastic.heartbeat import read_beat, read_beat_info

    path = tmp_path / "hb" / "rank0"
    assert read_beat(str(path)) is None
    fb = FileBeat(str(path))
    fb.beat(7)
    m1 = read_beat(str(path))
    assert m1 is not None
    assert path.read_text() == "7"
    fb.suppress(60)
    fb.beat(8)
    assert path.read_text() == "7"
    assert read_beat(str(path)) == m1
    info = read_beat_info(str(path))
    assert isinstance(info, BeatInfo) and info.step == 7


def test_scale_signals_pressure_and_drain(lm):
    reps, router = _mk_cluster(lm, n=2)
    sig = scale_signals(router.loads())
    assert sig["replicas_alive"] == 2
    assert sig["scale_up"] is False
    assert sig["drain_candidate"] is not None
    for _ in range(20):
        try:
            router.submit(prompts_for(1)[0], 4)
        except QueueFull:
            break
    sig = scale_signals(router.loads(), queue_pressure_frac=0.1)
    assert sig["queued"] > 0
    assert sig["drain_candidate"] is None
    router.run_until_idle()


def test_scale_filter_debounces_flapping_trace():
    f = ScaleSignalFilter(k_up=3, k_down=3, cooldown_s=10.0)
    up = {"scale_up": True, "drain_candidate": None}
    quiet = {"scale_up": False, "drain_candidate": None}
    t = 0.0
    for _ in range(20):
        assert f.update(up, now=t) == {"scale_up": False, "drain": None}
        assert f.update(quiet, now=t) == {"scale_up": False, "drain": None}
        t += 0.1
    assert not f.update(up, now=t)["scale_up"]
    assert not f.update(up, now=t)["scale_up"]
    assert f.update(up, now=t)["scale_up"]
    for _ in range(5):
        assert not f.update(up, now=t + 1.0)["scale_up"]
    assert f.update(up, now=t + 11.0)["scale_up"]


def test_scale_filter_drain_candidate_flap_resets_streak():
    f = ScaleSignalFilter(k_up=2, k_down=3, cooldown_s=0.0)

    def s(c):
        return {"scale_up": False, "drain_candidate": c}

    assert f.update(s(0), now=0.0)["drain"] is None
    assert f.update(s(0), now=0.1)["drain"] is None
    assert f.update(s(1), now=0.2)["drain"] is None
    assert f.update(s(1), now=0.3)["drain"] is None
    assert f.update(s(1), now=0.4)["drain"] == 1
    assert f.update(s(0), now=0.5)["drain"] is None
    assert f.update({"scale_up": False, "drain_candidate": None},
                    now=0.6)["drain"] is None
    assert f.update(s(0), now=0.7)["drain"] is None
    with pytest.raises(ValueError):
        ScaleSignalFilter(k_up=0)


def test_replica_gauges_carry_replica_suffix(lm):
    rep = Reporter()
    replica = Replica("r0", make_engine(lm), reporter=rep)
    h = replica.frontend.submit(prompts_for(1)[0], 4)
    while not h.done:
        replica.step()
    g = rep.summary()["gauges"]
    assert g["serving/running/replica/r0"]["value"] == 0
    assert g["serving/free_blocks/replica/r0"]["value"] == 64
    assert "serving/running" not in g


# ---------------------------------------------------------------------------
# Threaded soak, fleet metrics plane
# ---------------------------------------------------------------------------


def test_serving_cluster_threaded_failover_small(lm, oracle_streams):
    """The reference's threaded failover soak at a small size (6
    requests, 60 s bounds of its own): threaded replicas, concurrent
    submission, one replica killed mid-stream — every stream equals the
    reference's (the interleaving of the replica threads does not reach
    the tokens)."""
    prompts = prompts_for(6, rng_seed=21, lo=4, hi=12)
    shared = [int(t) for t in
              np.random.default_rng(37).integers(0, VOCAB, size=8)]
    prompts = [shared + p if i % 2 == 0 else p
               for i, p in enumerate(prompts)]
    want = oracle_streams(prompts, 8)
    reps = [Replica(i, make_engine(lm), max_queue=16, spec_tokens=2)
            for i in range(3)]
    router = ReplicaRouter(
        reps, health=HeartbeatMonitor([0, 1, 2], miss_after_s=1e9))
    done = threading.Event()
    with ThreadedClusterDriver(router) as drv:
        handles = [router.submit(p, 8, timeout_s=60.0) for p in prompts]
        while sum(len(h.tokens) for h in handles) < 5:
            router.step(drive_replicas=False)
        victim = next((h.replica_id for h in handles
                       if not h.done and h.replica_id is not None), 0)
        router.fail_replica(victim, "soak kill")
        drv.run_until_idle(timeout_s=60.0)
        done.set()
    assert done.is_set()
    for h, w in zip(handles, want):
        assert h.status == "finished", (h.request_id, h.status, h.error)
        assert h.tokens == w
    for r in reps:
        if r.replica_id != victim:
            r.engine.kv.assert_consistent()


def test_metrics_gossip_idempotent_under_dup_and_reorder():
    def snap(steps, tokens):
        r = Reporter()
        r.count("serving/steps", steps)
        r.count("serving/tokens", tokens)
        r.gauge(f"serving/running/replica/{steps}", steps)
        return r.summary()

    beats = [(1, 1, snap(1, 10)), (1, 2, snap(2, 25)),
             (2, 1, snap(3, 7)), (2, 2, snap(5, 9))]
    g = MetricsGossip()
    for rid, v, s in beats:
        assert g.observe(rid, v, s)
    want = g.fleet_view()
    assert want["counters"]["serving/steps"] == 2 + 5
    assert want["counters"]["serving/tokens"] == 25 + 9
    rng = random.Random(7)
    for _ in range(5):
        replay = beats * 3
        rng.shuffle(replay)
        g2 = MetricsGossip()
        for rid, v, s in replay:
            g2.observe(rid, v, s)
        assert g2.fleet_view() == want
        assert g2.version(1) == 2 and g2.version(2) == 2
    assert not g.observe(1, 5, None)
    assert not g.observe(1, 1, snap(99, 99))
    assert g.fleet_view() == want
    g.forget(2)
    assert g.replicas() == [1]
    assert g.fleet_view()["counters"]["serving/steps"] == 2
    assert g.latest(2) is None and g.version(2) is None


def _metrics_cluster(lm, **router_kw):
    mreps = {i: Reporter() for i in range(2)}
    reps = [Replica(i, make_engine(lm), role="both", reporter=mreps[i],
                    metrics_reporter=mreps[i], max_queue=8)
            for i in range(2)]
    return reps, ReplicaRouter(reps, reporter=Reporter(), **router_kw)


def test_fleet_view_tenants_and_dead_replica_series_drop(lm):
    reps, router = _metrics_cluster(
        lm, health=HeartbeatMonitor([0, 1], miss_after_s=1e9))
    prompts = prompts_for(4, rng_seed=19)
    handles = [router.submit(p, 6, tenant=f"t{i % 2}")
               for i, p in enumerate(prompts)]
    router.run_until_idle()
    assert all(h.status == "finished" for h in handles)
    view = router.fleet_view()
    produced = sum(len(h.tokens) for h in handles)
    assert (view["counters"]["tenant/t0/tokens_out"]
            + view["counters"]["tenant/t1/tokens_out"]) == produced
    assert (view["counters"]["tenant/t0/tokens_in"]
            + view["counters"]["tenant/t1/tokens_in"]
            ) == sum(len(p) for p in prompts)
    assert view["counters"]["tenant/t0/admit"] == 2
    assert view["gauges"]["tenant/t0/kv_page_seconds"]["value"] > 0
    for rid in (0, 1):
        assert any(k.endswith(f"/replica/{rid}") for k in view["gauges"])
    router.fail_replica(0, "test kill")
    view2 = router.fleet_view()
    for table in ("gauges", "counters", "histograms"):
        stale = [k for k in view2.get(table, {})
                 if k.endswith("/replica/0") or "/replica/0/" in k]
        assert not stale, (table, stale)
    assert 0 not in router.metrics.replicas()
    assert any(k.endswith("/replica/1") for k in view2["gauges"])
    reps[1].engine.kv.assert_consistent()


def test_retire_replica_forgets_metrics_snapshot(lm):
    reps, router = _metrics_cluster(lm)
    handles = [router.submit(p, 4, tenant="acme")
               for p in prompts_for(6, rng_seed=23)]
    router.run_until_idle()
    assert all(h.status == "finished" for h in handles)
    assert {h.replica_id for h in handles} == {0, 1}
    assert 1 in router.metrics.replicas()
    router.drain(1)
    router.migrate_out(1)
    router.run_until_idle()
    assert router.retire_replica(1)
    assert 1 not in router.metrics.replicas()
    view = router.fleet_view()
    assert not any(
        k.endswith("/replica/1") or "/replica/1/" in k
        for table in ("gauges", "counters", "histograms")
        for k in view.get(table, {}))
    assert view["counters"]["tenant/acme/tokens_out"] > 0


def test_migrate_out_mid_stream_and_add_replica(lm, oracle_streams):
    """``migrate_out`` moves a draining replica's live streams to a peer
    mid-decode, and a replica added later takes traffic: every stream
    equals the reference's."""
    prompts = prompts_for(4, rng_seed=31, lo=4, hi=10)
    want = oracle_streams(prompts, 8)
    reps, router = _mk_cluster(lm, n=2)
    handles = [router.submit(p, 8) for p in prompts]
    for _ in range(3):
        router.step()
    src = next(h.replica_id for h in handles if not h.done)
    router.drain(src)
    assert router.migrate_out(src) > 0
    router.run_until_idle()
    for h, w in zip(handles, want):
        assert h.status == "finished" and h.tokens == w
    router.add_replica(Replica(2, make_engine(lm)))
    router.drain(1 - src)
    h = router.submit(prompts[0], 8)
    router.run_until_idle()
    assert h.replica_id == 2 and h.tokens == want[0]


def test_snapshot_geometry_and_kvsnapshot_bytes():
    snap = KVSnapshot(seq_len=7, block_size=4, pages=[
        np.zeros((2, 4, 2, 8), np.float32)] * 2)
    assert snap.n_pages == 2 and snap.nbytes() == 2 * 2 * 4 * 2 * 8 * 4
