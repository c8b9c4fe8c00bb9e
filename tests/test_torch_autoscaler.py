"""The port's SLO-guarded autoscaler, heavy-tailed traffic harness and
chaos grammar against the JAX package, on the CPU.

The non-slow cases of ``tests/test_autoscaler.py`` (its three
``ScaleSignalFilter`` cases are ported in
``tests/test_torch_serving_cluster.py``): deterministic traffic, shedding
and jittered hints, the autoscaler's spawn / burn-rate / anomaly /
backfill / drain-migrate-retire decisions and the chaos grammar, on a
tiny fp32 fleet whose weights are the reference's init converted into
the port, every stream held to the reference engine's.  The autoscaler's
decisions equal the reference's on the same seeded load traces, and the
arrivals and chaos schedules equal the reference's on the same specs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from chainermn_tpu.elastic import chaos as jchaos
from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.observability.reporter import Reporter as JReporter
from chainermn_tpu.serving import TrafficSpec as JTrafficSpec
from chainermn_tpu.serving import engine as jengine
from chainermn_tpu.serving import workload as jworkload
from chainermn_tpu.serving.cluster import autoscaler as jautoscaler
from chainermn_tpu.serving.cluster import replica as jreplica
from chainermn_tpu_torch import convert
from chainermn_tpu_torch.elastic import chaos
from chainermn_tpu_torch.models.transformer import TransformerLM
from chainermn_tpu_torch.observability import AnomalyDetector, Reporter
from chainermn_tpu_torch.serving import (
    EngineConfig,
    InferenceEngine,
    QueueFull,
    TrafficSpec,
    workload,
)
from chainermn_tpu_torch.serving.cluster import (
    Autoscaler,
    AutoscalerConfig,
    HeartbeatMonitor,
    Replica,
    ReplicaLoad,
    ReplicaRouter,
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
def oracle(ref):
    """The reference engine's sequential stream of a prompt, memoised."""
    eng = jengine.InferenceEngine(ref[0], ref[1], jengine.EngineConfig(
        block_size=4, n_blocks=64, max_len=64, max_batch=4,
        prefill_buckets=(16, 32), batch_buckets=(1, 4),
        table_width_buckets=(16,), chunk_buckets=(8,)))
    memo = {}

    def run(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = list(eng.generate(list(prompt), n))
        return memo[key]

    return run


def make_engine(lm, **over):
    cfg = dict(block_size=4, n_blocks=64, max_len=64, max_batch=4)
    cfg.update(over)
    return InferenceEngine(lm, EngineConfig(**cfg), device="cpu")


def mk_fleet(lm, n=2, max_queue=8, reporter=None, **router_kw):
    reps = [Replica(i, make_engine(lm), role="both", reporter=reporter,
                    max_queue=max_queue) for i in range(n)]
    router = ReplicaRouter(
        reps, reporter=reporter,
        health=HeartbeatMonitor([r.replica_id for r in reps],
                                miss_after_s=30.0),
        **router_kw)
    return reps, router


def _arrival_key(a):
    return (a.index, a.t, tuple(a.prompt), a.max_new_tokens, a.priority,
            a.abusive, a.template, a.tenant)


# ---------------------------------------------------------------------------
# Traffic generator: determinism, shape, spec round-trip
# ---------------------------------------------------------------------------


def test_traffic_spec_parse_format_roundtrip():
    text = ("rate=80,requests=48,burst=6,abusive_frac=0.2,"
            "prompt_buckets=4-8:0.6|10-20:0.4,class_weights=0.3/0.7")
    spec = TrafficSpec.parse(text)
    assert spec.rate == 80.0 and spec.requests == 48
    assert spec.prompt_buckets == ((4, 8, 0.6), (10, 20, 0.4))
    assert spec.class_weights == (0.3, 0.7)
    assert TrafficSpec.parse(spec.format()) == spec
    assert spec.format() == JTrafficSpec.parse(text).format()
    assert TrafficSpec.parse("default") == TrafficSpec()
    assert TrafficSpec.parse("") == TrafficSpec()
    with pytest.raises(ValueError):
        TrafficSpec.parse("no_such_knob=3")
    with pytest.raises(ValueError):
        TrafficSpec.parse("rate")


def test_traffic_spec_scaled_moves_only_rate():
    spec = TrafficSpec(rate=50.0, requests=16)
    double = spec.scaled(2.0)
    assert double.rate == 100.0
    assert double.requests == spec.requests
    assert double.seed == spec.seed


def test_generate_is_deterministic_and_heavy_tailed():
    spec = TrafficSpec(seed=3, requests=200, abusive_frac=0.15)
    a1, a2 = workload.generate(spec), workload.generate(spec)
    assert a1 == a2
    assert [_arrival_key(a) for a in a1] == [
        _arrival_key(a) for a in jworkload.generate(
            JTrafficSpec(seed=3, requests=200, abusive_frac=0.15))]
    assert workload.generate(TrafficSpec(seed=4, requests=200)) != a1
    ts = [a.t for a in a1]
    assert all(b > a for a, b in zip(ts, ts[1:]))
    lo = min(lo for lo, _, _ in spec.prompt_buckets)
    hi = max(hi for _, hi, _ in spec.prompt_buckets)
    assert all(lo <= len(a.prompt) <= hi for a in a1)
    assert all(t < VOCAB for a in a1 for t in a.prompt)
    counts = np.bincount([a.template for a in a1],
                         minlength=spec.templates)
    assert counts[0] == counts.max() and counts[0] > len(a1) / 4
    by_tmpl = {}
    for a in a1:
        by_tmpl.setdefault(a.template, []).append(a.prompt)
    some = [ps for ps in by_tmpl.values() if len(ps) > 3][0]
    k = min(len(p) for p in some)
    assert len({p[:k] for p in some}) == 1
    abusive = [a for a in a1 if a.abusive]
    assert abusive
    assert all(a.priority == len(spec.class_weights) - 1 for a in abusive)
    assert {a.priority for a in a1} == {0, 1, 2}


def test_generate_burst_state_compresses_interarrivals():
    calm = workload.generate(TrafficSpec(
        seed=0, requests=300, burst=1.0, p_burst=0.0))
    bursty = workload.generate(TrafficSpec(
        seed=0, requests=300, burst=8.0, p_burst=0.3, p_calm=0.2))
    gaps = lambda arr: np.diff([a.t for a in arr])  # noqa: E731
    assert np.median(gaps(bursty)) < np.median(gaps(calm))


# ---------------------------------------------------------------------------
# Priority-aware shedding + jittered backpressure
# ---------------------------------------------------------------------------


def test_shed_evicts_cheapest_class_first(lm):
    reporter = Reporter()
    reps, router = mk_fleet(lm, n=1, max_queue=3, reporter=reporter)
    p = [1, 2, 3]
    low = [router.submit(p, 4, priority=2) for _ in range(3)]
    with pytest.raises(QueueFull):
        router.submit(p, 4, priority=2)
    mid = router.submit(p, 4, priority=1)
    top = router.submit(p, 4, priority=0)
    router.run_until_idle()
    assert mid.status == "finished" and top.status == "finished"
    shed = [h for h in low if h.status == "failed"]
    assert len(shed) == 2
    assert all(h.error.startswith("shed") for h in shed)
    counters = reporter.summary()["counters"]
    assert counters["serve/shed/2"] == 2
    assert counters["serve/rejected/2"] == 1
    assert counters["serve/admit/0"] == 1
    assert counters["serve/admit/1"] == 1
    assert counters["serve/admit/2"] == 3


def test_queue_full_hints_are_jittered(lm):
    reps, router = mk_fleet(lm, n=1, max_queue=1)
    router.submit([1, 2], 6)
    router.run_until_idle()
    router.submit([1, 2], 6)
    hints = []
    for _ in range(6):
        with pytest.raises(QueueFull) as ei:
            router.submit([1, 2], 4)
        hints.append(ei.value.retry_after_s)
    assert all(h is not None and h > 0 for h in hints)
    assert len(set(hints)) > 1
    router.run_until_idle()


def test_replay_polite_clients_honor_hints_abusive_slam():
    a_polite = workload.Arrival(index=0, t=0.0, prompt=(1,),
                                max_new_tokens=1, priority=1,
                                abusive=False, template=0)
    a_abusive = workload.Arrival(index=1, t=0.0, prompt=(1,),
                                 max_new_tokens=1, priority=2,
                                 abusive=True, template=0)

    class Done:
        status, done, error, tokens = "finished", True, None, [5]

    attempts = {0: 0, 1: 0}

    def submit(a):
        attempts[a.index] += 1
        if attempts[a.index] <= 5:
            raise QueueFull("full", retry_after_s=0.001)
        return Done()

    report = workload.replay([a_polite, a_abusive], submit,
                             drain_timeout_s=5.0)
    polite, abusive = report.outcomes
    assert polite.finished and polite.attempts == 6
    assert abusive.rejected and not abusive.finished
    summary = workload.summarize(report)
    assert summary["offered"] == 2
    assert summary["finished"] == 1
    assert summary["rejected"] == 1
    assert summary["retries"] == 5 + 3


# ---------------------------------------------------------------------------
# Autoscaler on a real fleet
# ---------------------------------------------------------------------------


def test_autoscaler_spawns_on_queue_pressure(lm):
    reporter = Reporter()
    reps, router = mk_fleet(lm, n=1, max_queue=4, reporter=reporter)

    def factory(rid):
        return Replica(rid, make_engine(lm), role="both",
                       reporter=reporter, max_queue=4)

    scaler = Autoscaler(router, factory, AutoscalerConfig(
        min_replicas=1, max_replicas=2, k_up=2, cooldown_s=0.0),
        reporter=reporter)
    for _ in range(4):
        router.submit([1, 2, 3], 6)
    assert scaler.step(now=0.0) is None
    ev = scaler.step(now=0.1)
    assert ev is not None and ev["action"] == "spawn"
    assert ev["reason"] == "watermark"
    assert "as0" in router.replicas
    for i in range(6):
        assert scaler.step(now=0.2 + i * 0.1) is None
    router.run_until_idle()
    counters = reporter.summary()["counters"]
    assert counters["autoscaler/spawn"] == 1
    assert counters["serving/cluster/replicas_added"] == 1


def test_autoscaler_burn_rate_forces_scale_up(lm):
    reporter = Reporter()
    reps, router = mk_fleet(lm, n=1, reporter=reporter)
    scaler = Autoscaler(
        router, lambda rid: Replica(rid, make_engine(lm), reporter=reporter),
        AutoscalerConfig(min_replicas=1, max_replicas=2, k_up=2,
                         cooldown_s=0.0),
        reporter=reporter)
    reporter.gauge("slo/burn_rate/decode", 2.5)
    assert scaler.step(now=0.0) is None
    ev = scaler.step(now=0.1)
    assert ev is not None and ev["action"] == "spawn"
    assert ev["reason"] == "burn_rate"
    gauges = reporter.summary()["gauges"]
    assert gauges["autoscaler/max_burn_rate"]["value"] == 2.5


def test_autoscaler_backfills_below_floor_without_hysteresis(lm, oracle):
    reporter = Reporter()
    reps, router = mk_fleet(lm, n=2, reporter=reporter)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]
    scaler = Autoscaler(
        router, lambda rid: Replica(rid, make_engine(lm), reporter=reporter),
        AutoscalerConfig(min_replicas=2, max_replicas=3, k_up=50,
                         cooldown_s=1e9),
        reporter=reporter)
    handles = [router.submit(p, 8) for p in prompts]
    for _ in range(3):
        router.step()
    router.fail_replica(0, reason="test kill")
    ev = scaler.step(now=0.0)
    assert ev is not None and ev["action"] == "spawn"
    assert ev["reason"] == "backfill"
    router.run_until_idle()
    for h, p in zip(handles, prompts):
        assert h.status == "finished"
        assert list(h.tokens) == oracle(p, 8)


def test_autoscaler_drain_migrate_retire_zero_stream_loss(lm, oracle):
    reporter = Reporter()
    reps, router = mk_fleet(lm, n=2, reporter=reporter)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [10, 11, 12]]

    def factory(rid):  # pragma: no cover - never called here
        raise AssertionError("scale-down must not spawn")

    scaler = Autoscaler(router, factory, AutoscalerConfig(
        min_replicas=1, max_replicas=2, cooldown_s=0.0), reporter=reporter)
    handles = [router.submit(p, 10) for p in prompts]
    for _ in range(5):
        router.step()
    assert any(len(h.tokens) > 0 for h in handles)
    assert scaler.force_drain(0, now=0.0)
    assert not scaler.force_drain(1, now=0.0)
    for i in range(50):
        scaler.step(now=0.1 * i)
        router.step()
        if 0 not in router.replicas:
            break
    assert 0 not in router.replicas
    assert [ev["action"] for ev in scaler.events] == ["drain", "retire"]
    router.run_until_idle()
    for h, p in zip(handles, prompts):
        assert h.status == "finished"
        assert list(h.tokens) == oracle(p, 10)
    assert sum(h.migrations for h in handles) >= 1
    assert sum(h.failovers for h in handles) == 0
    reps[1].engine.kv.assert_consistent()
    assert 0 not in router.health.check(now=1e9)
    counters = reporter.summary()["counters"]
    assert counters["serving/cluster/replicas_retired"] == 1
    assert counters["autoscaler/drain"] == 1
    assert counters["autoscaler/retire"] == 1


def test_force_drain_refuses_below_floor(lm):
    reps, router = mk_fleet(lm, n=1)
    scaler = Autoscaler(router, lambda rid: None,
                        AutoscalerConfig(min_replicas=1),
                        reporter=Reporter())
    assert not scaler.force_drain(0)
    assert not scaler.force_drain("nope")


def test_autoscaler_anomaly_forces_scale_up(lm):
    reporter = Reporter()
    reps, router = mk_fleet(lm, n=1, reporter=reporter)
    det = AnomalyDetector(reporter=reporter, window=2, baseline=8,
                          min_samples=2, drop_factor=0.5)
    tokens = 0.0
    for i in range(6):
        tokens += 100.0
        det.update({"counters": {"serving/tokens": tokens}}, now=float(i))
    assert not det.alarming()
    for i in range(6, 8):
        tokens += 5.0
        det.update({"counters": {"serving/tokens": tokens}}, now=float(i))
    assert det.alarming()
    scaler = Autoscaler(
        router, lambda rid: Replica(rid, make_engine(lm), reporter=reporter),
        AutoscalerConfig(min_replicas=1, max_replicas=2, k_up=2,
                         cooldown_s=0.0),
        reporter=reporter, anomaly=det)
    assert scaler.step(now=0.0) is None
    ev = scaler.step(now=0.1)
    assert ev is not None and ev["action"] == "spawn"
    assert ev["reason"] == "anomaly"
    assert "as0" in router.replicas
    s = reporter.summary()
    assert s["gauges"]["anomaly/goodput_drop"]["value"] == 1.0
    assert s["counters"]["anomaly/goodput_drop"] == 1


# ---------------------------------------------------------------------------
# The controller's decisions against the reference's on seeded traces
# ---------------------------------------------------------------------------


class _FakeReplica:
    def __init__(self, rid):
        self.replica_id, self.alive, self.draining = rid, True, False
        self.live = 0


class _FakeRouter:
    """The router surface the autoscaler drives, over a seeded load trace:
    each ``loads()`` call draws every replica's pages, queue and batch
    from ``rng``; ``migrate_out`` moves one live stream a call."""

    def __init__(self, n, rng, load_cls, reporter):
        self.replicas = {i: _FakeReplica(i) for i in range(n)}
        self.rng, self.load_cls, self.reporter = rng, load_cls, reporter

    def loads(self, now=None):
        out = []
        for rid, r in self.replicas.items():
            free = int(self.rng.integers(0, 65))
            out.append(self.load_cls(
                replica_id=rid, role="both", alive=r.alive,
                draining=r.draining, free_blocks=free, n_blocks=64,
                queue_depth=int(self.rng.integers(0, 9)), max_queue=8,
                running=int(self.rng.integers(0, 5)), max_batch=4))
        return out

    def add_replica(self, rep):
        self.replicas[rep.replica_id] = rep

    def drain(self, rid):
        self.replicas[rid].draining = True
        self.replicas[rid].live = int(self.rng.integers(0, 4))

    def migrate_out(self, rid):
        r = self.replicas[rid]
        r.live = max(0, r.live - 1)
        return 1

    def retire_replica(self, rid):
        if self.replicas[rid].live:
            return False
        del self.replicas[rid]
        return True


def _drive(pkg_scaler, load_cls, reporter, seed, steps=120):
    rng = np.random.default_rng(seed)
    router = _FakeRouter(2, rng, load_cls, reporter)
    scaler = pkg_scaler(router, _FakeReplica, reporter)
    decisions = []
    for i in range(steps):
        u = rng.random()
        if u < 0.05 and router.replicas:  # a replica dies
            rid = sorted(router.replicas, key=str)[0]
            router.replicas.pop(rid)
        reporter.gauge("slo/burn_rate/decode",
                       float(rng.choice([0.2, 0.5, 1.5])))
        ev = scaler.step(now=0.25 * i)
        decisions.append(None if ev is None else
                         (ev["action"], ev.get("reason"), ev["replica"]))
    return decisions, [(e["action"], e.get("reason"), e["replica"])
                       for e in scaler.events]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_autoscaler_decisions_equal_reference_on_seeded_traces(seed):
    """Both controllers see the same seeded load, burn-rate and death
    trace (the RNG is consumed identically): every step's decision and
    the whole event log are equal."""
    cfg = dict(min_replicas=2, max_replicas=4, k_up=2, k_down=3,
               cooldown_s=1.0)

    def mine(router, fac, rep):
        return Autoscaler(router, fac, AutoscalerConfig(**cfg), reporter=rep)

    def theirs(router, fac, rep):
        return jautoscaler.Autoscaler(
            router, fac, jautoscaler.AutoscalerConfig(**cfg), reporter=rep)

    got = _drive(mine, ReplicaLoad, Reporter(), seed)
    want = _drive(theirs, jreplica.ReplicaLoad, JReporter(), seed)
    assert got == want
    assert {a for a, _, _ in got[1]} & {"spawn", "drain"}


# ---------------------------------------------------------------------------
# Chaos grammar: serving coordinates + timed firing
# ---------------------------------------------------------------------------


def test_chaos_grammar_replica_time_coordinates():
    sched = chaos.ChaosSchedule.parse("kill:replica=1:at=0.25")
    (f,) = sched.faults
    assert f.kind == "kill" and f.replica == 1 and f.at == 0.25
    assert chaos.ChaosSchedule.parse(sched.format()).faults == sched.faults
    chaos.ChaosSchedule.parse("kill:rank=1:step=5")
    with pytest.raises(ValueError):
        chaos.ChaosSchedule.parse("kill:replica=1")
    assert chaos.validate_grammar() == []


@pytest.mark.parametrize("text", jchaos.GRAMMAR_CORPUS_OK
                         + jchaos.GRAMMAR_CORPUS_BAD)
def test_chaos_grammar_equals_reference(text):
    """Each corpus schedule parses to the reference's faults and formats
    to its text; each invalid one raises in both."""
    try:
        want = jchaos.ChaosSchedule.parse(text)
    except ValueError:
        with pytest.raises(ValueError):
            chaos.ChaosSchedule.parse(text)
        return
    got = chaos.ChaosSchedule.parse(text)
    assert got.format() == want.format()
    assert [dataclass_tuple(f) for f in got.faults] == \
        [dataclass_tuple(f) for f in want.faults]
    for r in (0, 1):
        assert len(got.for_rank(r, 0)) == len(want.for_rank(r, 0))
    assert [f.format() for f in got.timed()] == \
        [f.format() for f in want.timed()]


def dataclass_tuple(f):
    return (f.kind, f.rank, f.step, f.gen, f.secs, f.inc, f.replica, f.at)


def test_timed_chaos_fires_in_order_exactly_once():
    sched = chaos.ChaosSchedule.parse(
        "kill:replica=0:at=0.5;term:replica=1:at=0.2")
    now = [100.0]
    tc = chaos.TimedChaos(sched, clock=lambda: now[0])
    tc.start()
    assert tc.pending == 2
    assert tc.due() == ()
    now[0] = 100.3
    assert [f.kind for f in tc.due()] == ["term"]
    now[0] = 101.0
    assert [(f.kind, f.replica) for f in tc.due()] == [("kill", 0)]
    assert tc.pending == 0
    assert tc.due() == ()


def test_chaos_engine_fires_step_faults_once(monkeypatch):
    """The worker-side executor: ``hb_stall`` suppresses the heartbeat at
    its step and a ``kill`` fires exactly once (SIGKILL intercepted)."""
    import os
    import signal

    sent = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: sent.append(sig))

    class Beat:
        def __init__(self):
            self.suppressed = []

        def suppress(self, secs):
            self.suppressed.append(secs)

    beat = Beat()
    eng = chaos.ChaosEngine(chaos.ChaosSchedule.parse(
        "kill:rank=1:step=5;hb_stall:rank=1:step=3:secs=30;"
        "kill:rank=0:step=1"), rank=1, incarnation=0, heartbeat=beat)
    for step in range(8):
        eng.on_step(step)
    assert beat.suppressed == [30.0]
    assert sent == [signal.SIGKILL]


# ---------------------------------------------------------------------------
# End-to-end replay over a real fleet (small, in-process)
# ---------------------------------------------------------------------------


def test_traffic_replay_over_fleet_is_bit_exact(lm, oracle):
    spec = TrafficSpec(seed=11, requests=10, rate=500.0,
                       prompt_buckets=((3, 8, 1.0),),
                       output_buckets=((3, 6, 1.0),),
                       prefix_len=6, vocab=VOCAB)
    arrivals = workload.generate(spec)
    reps, router = mk_fleet(lm, n=2, max_queue=16)
    report = workload.replay(
        arrivals,
        lambda a: router.submit(list(a.prompt), a.max_new_tokens,
                                priority=a.priority),
        pump=lambda: router.step(), drain_timeout_s=120.0)
    summary = workload.summarize(report)
    assert summary["finished"] == len(arrivals)
    for o in report.outcomes:
        assert o.finished
        assert list(o.handle.tokens) == oracle(o.arrival.prompt,
                                               o.arrival.max_new_tokens)
    assert summary["latency_p99_s"] >= summary["latency_p50_s"]


def test_traffic_tenant_dimension_deterministic_and_zipf():
    base = workload.generate(TrafficSpec(seed=3, requests=60))
    spec = TrafficSpec(seed=3, requests=60, tenants=4)
    arr = workload.generate(spec)
    key = lambda a: (a.t, a.prompt, a.max_new_tokens, a.priority,  # noqa
                     a.template, a.abusive)
    assert [key(a) for a in base] == [key(a) for a in arr]
    assert all(a.tenant is None for a in base)
    ids = [a.tenant for a in arr]
    assert ids == [a.tenant for a in jworkload.generate(
        JTrafficSpec(seed=3, requests=60, tenants=4))]
    assert set(ids) <= {f"t{k}" for k in range(4)}
    counts = {t: ids.count(t) for t in set(ids)}
    assert counts["t0"] == max(counts.values())
    assert workload.generate(spec) == arr
    s2 = TrafficSpec.parse(spec.format())
    assert s2.tenants == 4 and s2.tenant_zipf == spec.tenant_zipf


def test_traffic_summarize_per_tenant_curves(lm):
    reps, router = mk_fleet(lm, n=2, max_queue=16)
    spec = TrafficSpec(seed=11, requests=8, rate=200.0, tenants=3,
                       prompt_buckets=((3, 8, 1.0),),
                       output_buckets=((3, 5, 1.0),), vocab=VOCAB)
    arrivals = workload.generate(spec)
    report = workload.replay(
        arrivals,
        lambda a: router.submit(list(a.prompt), a.max_new_tokens,
                                priority=a.priority, tenant=a.tenant),
        pump=router.step, speedup=50.0)
    router.run_until_idle()
    summary = workload.summarize(report)
    per_tenant = summary["per_tenant"]
    assert set(per_tenant) <= {f"t{k}" for k in range(3)}
    assert sum(d["offered"] for d in per_tenant.values()) == 8
    assert sum(d["finished"] for d in per_tenant.values()) \
        == summary["finished"]
    assert sum(d["tokens"] for d in per_tenant.values()) == \
        summary["goodput_tokens"]
    plain = workload.summarize(workload.ReplayReport(
        outcomes=report.outcomes[:0], wall_s=1.0))
    assert "per_tenant" not in plain


def test_traffic_diurnal_envelope_deterministic_and_off_switch():
    base = workload.generate(TrafficSpec(seed=5, requests=40))
    flat = workload.generate(TrafficSpec(seed=5, requests=40, diurnal=0.0))
    assert flat == base
    spec = TrafficSpec(seed=5, requests=40, diurnal=0.8,
                       diurnal_period_s=10.0)
    arr = workload.generate(spec)
    assert workload.generate(spec) == arr
    assert [a.t for a in arr] == [a.t for a in jworkload.generate(
        JTrafficSpec(seed=5, requests=40, diurnal=0.8,
                     diurnal_period_s=10.0))]
    key = lambda a: (a.prompt, a.max_new_tokens, a.priority,  # noqa
                     a.template, a.abusive)
    assert [key(a) for a in arr] == [key(a) for a in base]
    assert [a.t for a in arr] != [a.t for a in base]
    s2 = TrafficSpec.parse(spec.format())
    assert s2.diurnal == 0.8 and s2.diurnal_period_s == 10.0
    assert TrafficSpec.parse(spec.format()) == spec


def test_traffic_diurnal_envelope_shape():
    spec = TrafficSpec(seed=5, diurnal=0.8, diurnal_period_s=10.0)
    env = [spec.diurnal_envelope(t) for t in
           [10.0 * k / 16 for k in range(16)]]
    assert max(env) > 1.0 > min(env)
    assert spec.diurnal_envelope(3.0) == pytest.approx(
        spec.diurnal_envelope(13.0))
    deep = TrafficSpec(seed=5, diurnal=5.0, diurnal_period_s=10.0)
    assert all(deep.diurnal_envelope(10.0 * k / 64) >= 0.05
               for k in range(64))
    assert TrafficSpec(seed=5).diurnal_envelope(3.0) == 1.0


def test_tenant_fair_admission_under_doubled_load(lm):
    reporter = Reporter()
    reps, router = mk_fleet(lm, n=2, max_queue=32, reporter=reporter)
    spec = TrafficSpec(seed=11, requests=16, rate=120.0, tenants=3,
                       prompt_buckets=((3, 8, 1.0),),
                       output_buckets=((3, 5, 1.0),),
                       vocab=VOCAB).scaled(2.0)
    weights = spec.tenant_weights()
    assert weights["t0"] > weights["t2"]
    for r in reps:
        r.scheduler.set_tenant_weights(weights)
    arrivals = workload.generate(spec)
    report = workload.replay(
        arrivals,
        lambda a: router.submit(list(a.prompt), a.max_new_tokens,
                                priority=a.priority, tenant=a.tenant),
        pump=router.step, speedup=50.0)
    router.run_until_idle()
    summary = workload.summarize(report)
    assert summary["finished"] == 16
    for t, d in summary["per_tenant"].items():
        assert d["finished"] == d["offered"], (t, d)
    gauges = reporter.summary()["gauges"]
    assert any(k.startswith("serve/tenant_deficit/") for k in gauges)
