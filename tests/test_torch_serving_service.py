"""The port's multi-process serving tier (``serving.cluster.service`` and
``shard_group`` over ``communicators.kvtransport``) against the JAX
package, on the CPU.

Real processes (``tests/_torch_serve_mp_worker.py``, no JAX): a router
holding the fleet's ``TCPStore`` master and replica processes, at the
tiny fp32 model of ``tests/test_torch_serving_cluster.py`` on weights
converted from the reference's init.  The cases of the reference's
``tests/test_multiprocess.py`` serving soaks — clean, a replica
SIGKILLed mid-stream with the flight postmortem, two shard groups with a
follower SIGKILLed, a metrics scrape during a kill, heavy-tailed traffic
under SLO gauges, gossip prefix routing, streaming prefix registration —
each stream held to the reference engine's token for token; ``plan_groups`` against the
reference's; and every frame the processes exchanged against
``tests/golden/wire_schemas.json``.  Each process is joined under 60 s
and killed on expiry.
"""

import json
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from chainermn_tpu.models.transformer import TransformerLM as JaxLM
from chainermn_tpu.observability import tracing as jtracing
from chainermn_tpu.serving import engine as jengine
from chainermn_tpu.serving.cluster import shard_group as jshard
from chainermn_tpu_torch import convert
from chainermn_tpu_torch.observability import tracing
from chainermn_tpu_torch.serving.cluster import shard_group

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_serve_mp_worker.py")
GOLDEN = os.path.join(HERE, "golden", "wire_schemas.json")
CFG = dict(vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=2,
           max_len=64)
JOIN_S = 60


@pytest.fixture(scope="module")
def ref():
    jlm = JaxLM(**CFG, dtype=jnp.float32)
    params = jlm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    return jlm, params


@pytest.fixture(scope="module")
def weights(ref, tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "lm.pt"
    torch.save(convert.flax_to_state_dict(jax.device_get(ref[1])), path)
    return str(path)


@pytest.fixture(scope="module")
def oracle(ref):
    """The reference engine's sequential streams, memoised by prompt."""
    eng = jengine.InferenceEngine(ref[0], ref[1], jengine.EngineConfig(
        block_size=4, n_blocks=64, max_len=64, max_batch=2,
        prefill_buckets=(16, 32), batch_buckets=(1, 2),
        table_width_buckets=(16,), chunk_buckets=(8,)))
    memo = {}

    def run(prompt, n):
        key = (tuple(prompt), n)
        if key not in memo:
            memo[key] = list(eng.generate(list(prompt), n))
        return memo[key]

    return run


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.dirname(HERE), env.get("PYTHONPATH")) if p)
    return env


def launch(nproc, kill_after, mode, weights, outdir):
    """Start the fleet, join each process under ``JOIN_S`` (killing the
    rest on expiry); returns (exit codes, outputs)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(i), str(nproc), str(port),
         str(kill_after), mode, weights, str(outdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env()) for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=JOIN_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("serving fleet did not finish in time:\n"
                    + "\n".join(p.communicate()[0] or "" for p in procs))
    return [p.returncode for p in procs], outs


def router_results(out):
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith("SERVE_RESULTS ")]
    return json.loads(line[len("SERVE_RESULTS "):])


def assert_streams_match_reference(doc, oracle):
    failovers = 0
    for g, (p, n) in enumerate(zip(doc["prompts"], doc["news"])):
        rr = doc["results"][str(g)]
        assert rr["status"] == "finished", (g, rr)
        assert rr["tokens"] == oracle(p, n), (g, rr["tokens"])
        failovers += rr["failovers"]
    return failovers


def assert_frames_match_golden(outdir):
    """Every CMD dict carries exactly its golden ``cmd:<op>`` keys; every
    EVT event and group frame has its golden ``frame:<kind>`` arity."""
    with open(GOLDEN) as f:
        schemas = json.load(f)["schemas"]
    seen = set()
    for name in os.listdir(outdir):
        if not name.startswith("frames_"):
            continue
        with open(os.path.join(outdir, name)) as f:
            for line in f:
                r = json.loads(line)
                if "op" in r and r["tag"] == 1:
                    want = schemas[f"cmd:{r['op']}"]["keys"]
                    assert r["keys"] == want, (r, want)
                    seen.add(f"cmd:{r['op']}")
                elif "kind" in r:
                    want = schemas[f"frame:{r['kind']}"]["arity"]
                    assert r["arity"] in want, (r, want)
                    seen.add(f"frame:{r['kind']}")
    return seen


def test_service_clean_run_matches_reference(weights, oracle, tmp_path):
    """Router + 2 replica processes, nobody dies: every stream equals the
    reference engine's, no failovers, both replicas stop cleanly (their
    pools pass ``assert_consistent`` inside ``run_replica``)."""
    codes, outs = launch(3, 0, "plain", weights, tmp_path)
    assert codes == [0, 0, 0], "\n".join(outs)
    doc = router_results(outs[0])
    assert assert_streams_match_reference(doc, oracle) == 0
    assert "SERVE_REPLICA_OK 1 stopped" in outs[1]
    assert "SERVE_REPLICA_OK 2 stopped" in outs[2]
    seen = assert_frames_match_golden(tmp_path)
    assert {"cmd:submit", "cmd:stop", "frame:tok", "frame:done",
            "frame:load"} <= seen, seen


def test_service_survives_replica_kill9_with_flight_postmortem(
        weights, oracle, tmp_path):
    """The highest rank SIGKILLs itself after 5 streamed tokens with
    sequences live in its pool: every request still finishes equal to the
    reference engine's stream (failover re-prefills from the committed
    prefix).  The postmortem stitches the dead rank's flight file into
    the router's root spans: one trace per request, no orphans, monotone
    clocks, a failover event, and a request carrying both replicas'
    spans — and the reference's ``read_flight_dir`` reads the same rows."""
    codes, outs = launch(3, 5, "flight", weights, tmp_path)
    assert codes[2] == -9, f"rank 2 should die by SIGKILL: {codes}\n" \
        + "\n".join(outs)
    assert codes[0] == 0 and codes[1] == 0, "\n".join(outs)
    assert "SERVE_REPLICA_OK 1" in outs[1]
    doc = router_results(outs[0])
    assert assert_streams_match_reference(doc, oracle) > 0

    pattern = str(tmp_path / "flight_*.jsonl")
    rows = tracing.read_flight_dir(pattern)
    assert rows and rows == jtracing.read_flight_dir(pattern)
    trees = tracing.stitch(rows)
    assert len(trees) == 6
    crossed = []
    for tid, t in trees.items():
        v = tracing.validate_trace(t["spans"])
        assert not v["orphans"] and v["connected"] and v["monotone"], \
            (tid, v)
        if {1, 2} <= {s.get("replica") for s in t["spans"]}:
            crossed.append(tid)
    assert crossed
    assert any(r["name"] == "failover" for r in rows
               if r.get("event") == "evt")
    assert tracing.stage_percentiles(rows) == \
        jtracing.stage_percentiles(rows)
    assert_frames_match_golden(tmp_path)


def test_service_shard_groups_survive_follower_kill9(weights, oracle,
                                                     tmp_path):
    """Two shard groups of 2 (leaders 1 and 3, followers 2 and 4);
    follower rank 2 SIGKILLs itself after replaying 4 mirrored steps.
    Its leader sees ``PeerGone`` and exits, the router fails the whole
    group over to leader 3, and every stream equals the reference
    engine's; the survivor group stops cleanly."""
    codes, outs = launch(5, 4, "tpgroup", weights, tmp_path)
    assert codes[2] == -9, f"follower rank 2 should die: {codes}\n" \
        + "\n".join(outs)
    assert codes[0] == 0, outs[0]
    assert "SERVE_REPLICA_OK 1 follower gone" in outs[1], outs[1]
    assert "SERVE_REPLICA_OK 3 stopped" in outs[3], outs[3]
    assert "SERVE_REPLICA_OK 4 stopped" in outs[4], outs[4]
    doc = router_results(outs[0])
    assert assert_streams_match_reference(doc, oracle) > 0
    moved = [g for g, r in doc["results"].items() if r["failovers"]]
    assert moved and all(doc["results"][g]["replica"] == 3 for g in moved)
    seen = assert_frames_match_golden(tmp_path)
    assert {"frame:step", "frame:beat", "frame:stop"} <= seen, seen


def test_service_metrics_scrape_survives_kill9(weights, oracle, tmp_path):
    """The router serves its merged fleet view at ``/metrics`` while the
    highest rank is SIGKILLed: the dead replica's per-replica series are
    scraped while it lives and gone from the final scrape, fleet
    counters are monotone on either side of the one step-down, and the
    per-tenant token counters survive the failover."""
    codes, outs = launch(3, 12, "metrics", weights, tmp_path)
    assert codes[2] == -9, f"rank 2 should die by SIGKILL: {codes}\n" \
        + "\n".join(outs)
    assert codes[0] == 0 and codes[1] == 0, "\n".join(outs)
    doc = router_results(outs[0])
    assert assert_streams_match_reference(doc, oracle) > 0
    with open(tmp_path / "scrapes.json") as f:
        scrapes = json.load(f)
    assert len(scrapes) >= 3, len(scrapes)
    dead = 'replica="2"'
    lived = [i for i, s in enumerate(scrapes) if dead in s]
    assert lived, "the dead replica's series were never scraped"
    assert dead not in scrapes[-1]
    assert 'replica="1"' in scrapes[-1]
    ctr = re.compile(
        r'chainermn_tpu_counter_total\{name="([^"]+)"\} (\S+)')
    final = {m.group(1): float(m.group(2))
             for m in ctr.finditer(scrapes[-1])}
    for t in ("t0", "t1"):
        for which in ("tokens_in", "tokens_out"):
            assert final.get(f"tenant/{t}/{which}", 0.0) > 0, final
    cut = lived[-1] + 1
    for seg in (scrapes[:cut], scrapes[cut:]):
        prev = {}
        for s in seg:
            cur = {m.group(1): float(m.group(2)) for m in ctr.finditer(s)}
            for k, v in prev.items():
                assert cur.get(k, 0.0) >= v, (k, v, cur.get(k))
            prev = cur


def test_service_traffic_kill9_keeps_slo_green(weights, oracle, tmp_path):
    """The reference's traffic soak: a seeded heavy-tailed workload (MMPP
    bursts, Zipf shared prefixes, mixed lengths) under an SLO-wired
    router tracer, the highest rank SIGKILLed at 6 tokens: every stream
    equals the reference engine's, at least one failed over, and every
    ``slo/burn_rate/*`` gauge stays below 1."""
    codes, outs = launch(3, 6, "traffic", weights, tmp_path)
    assert codes[2] == -9, f"rank 2 should die by SIGKILL: {codes}\n" \
        + "\n".join(outs)
    assert codes[0] == 0 and codes[1] == 0, "\n".join(outs)
    doc = router_results(outs[0])
    assert assert_streams_match_reference(doc, oracle) > 0
    assert doc["burns"] and max(doc["burns"].values()) < 1.0, doc["burns"]


def test_service_gossip_routes_wave_two_to_the_holder(weights, oracle,
                                                      tmp_path):
    """The reference's gossip soak: router + 3 replicas with the model
    draft and chunked prefill; rank 1, which owns the template request,
    dies at 6 tokens, a survivor re-prefills the template, and both
    gated wave-2 requests route to that survivor through the gossiped
    digests alone.  Every stream equals the reference engine's."""
    codes, outs = launch(4, 6, "gossip", weights, tmp_path)
    assert codes[1] == -9, f"rank 1 should die by SIGKILL: {codes}\n" \
        + "\n".join(outs)
    assert codes[0] == 0 and codes[2] == 0 and codes[3] == 0, \
        "\n".join(outs)
    doc = router_results(outs[0])
    assert assert_streams_match_reference(doc, oracle) > 0
    res = doc["results"]
    holder = res["0"]["replica"]
    assert holder in (2, 3), res["0"]
    assert [res["6"]["replica"], res["7"]["replica"]] == [holder, holder]


def test_service_longctx_follower_routes_mid_prefill(weights, oracle,
                                                     tmp_path):
    """The reference's long-context soak: a document prefilled in chunks
    of 4 registers each slice's pages as it goes; a follower gated on 6
    gossiped pages arrives mid-prefill and routes to the warm replica.
    Both streams equal the reference engine's."""
    codes, outs = launch(3, 0, "longctx", weights, tmp_path)
    assert codes == [0, 0, 0], "\n".join(outs)
    doc = router_results(outs[0])
    assert assert_streams_match_reference(doc, oracle) == 0
    res = doc["results"]
    assert res["1"]["replica"] == res["0"]["replica"] in (1, 2), res


@pytest.mark.parametrize("size", range(1, 10))
def test_plan_groups_equals_reference(size):
    """Every (tp, pp) that divides the ``size - 1`` replica ranks plans
    the same groups as the reference; every other one raises as it
    does."""
    for tp in range(1, 9):
        for pp in range(1, 9):
            try:
                want = jshard.plan_groups(size, tp, pp)
            except ValueError:
                with pytest.raises(ValueError):
                    shard_group.plan_groups(size, tp, pp)
                continue
            got = shard_group.plan_groups(size, tp, pp)
            assert [(g.leader, g.followers, g.group_size, g.pp_stages,
                     g.ranks, g.n_shards) for g in got] == \
                [(g.leader, g.followers, g.group_size, g.pp_stages,
                  g.ranks, g.n_shards) for g in want]
