"""``python -m chainermn_tpu_torch.tools.serve`` on the CPU, as a user runs
it: the in-process fleet, a multi-process fleet with a shard group, the
local launcher's tracing and metrics outputs, the traffic + autoscale +
chaos line of the reference's slow CLI smoke
(``tests/test_autoscaler.py``), and the refusal to start without a card
unless given ``--device cpu``.  Each run is a subprocess joined under 60
s (the launcher joins its own replica processes under 60 s)."""

import json
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SMALL = ["--vocab", "32", "--d-model", "16", "--d-ff", "32",
         "--max-len", "64", "--block-size", "4", "--n-blocks", "32",
         "--requests", "4", "--new-tokens", "6", "--prompt-len", "8"]


def run_cli(*argv, timeout=60):
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    return subprocess.run(
        [sys.executable, "-m", "chainermn_tpu_torch.tools.serve", *argv],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def reports(proc):
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    return {r["mode"]: r for r in lines}


def test_cli_local_replicas_verify():
    """The reference's ``test_serve_cli_local_verify_smoke``: two
    in-process replicas, every stream equal to the oracle's."""
    proc = run_cli("--device", "cpu", "--replicas", "2", "--verify", *SMALL)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = reports(proc)["local"]
    assert out["parity"] == "ok"
    assert out["statuses"] == {"finished": 4}
    assert out["tokens"] == 24
    assert out["device"] == "cpu"


def test_cli_shard_group_verify():
    """``--tp 2 --verify``: the launcher starts a leader and a follower
    mirror as processes, this one routes; greedy and sampled streams
    equal the oracle's, both shards hold the same weights, and both
    exit cleanly (the follower replayed the leader's steps)."""
    proc = run_cli("--device", "cpu", "--tp", "2", "--verify", *SMALL)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rep = reports(proc)
    router, launcher = rep["router"], rep["launcher"]
    assert router["parity"] == "ok" and router["parity_sampled"] == 2
    assert router["statuses"] == {"finished": 4}
    assert router["tp"] == 2 and router["groups"] == 1
    kids = launcher["processes"]
    assert [k["returncode"] for k in kids] == [0, 0]
    assert kids[0]["report"]["reason"] == "stopped"
    assert kids[1]["report"]["applied"] > 0
    assert kids[0]["report"]["weights_crc32"] == \
        kids[1]["report"]["weights_crc32"]


def test_cli_groups_trace_metrics_warm_start(tmp_path):
    """Two replica processes with ``--warm-start``, flight files, the
    stitched Chrome trace and the router's metrics port file: every
    stream verifies, the trace stitches every process's spans, and the
    latency table is measured from the traffic's release."""
    trace = tmp_path / "trace.json"
    port_file = tmp_path / "port"
    proc = run_cli("--device", "cpu", "--groups", "2", "--verify",
                   "--warm-start", "--max-queue", "2",
                   "--flight-dir", str(tmp_path / "flight"),
                   "--trace-out", str(trace),
                   "--metrics-port-file", str(port_file), *SMALL)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rep = reports(proc)
    router = rep["router"]
    assert router["parity"] == "ok" and router["replicas"] == 2
    assert {"request", "placement", "decode"} <= set(router["trace_stages"])
    lat = router["latency"]
    assert 0 < lat["ttft_p50_s"] <= lat["ttft_p99_s"]
    assert router["serve_tokens_per_sec"] > 0
    assert router["ready_s"] > 0 and port_file.read_text().isdigit()
    doc = json.loads(trace.read_text())
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M"}
    assert {"chainermn_tpu.serve replica=router",
            "chainermn_tpu.serve replica=1",
            "chainermn_tpu.serve replica=2"} <= names
    streamed = [k["report"]["streamed"] for k in rep["launcher"]["processes"]]
    assert sum(streamed) == router["tokens"] and min(streamed) > 0


def test_cli_traffic_autoscale_chaos():
    """The reference's slow smoke line: heavy-tailed traffic over two
    in-process replicas, the autoscaler on, replica 1 killed mid-replay —
    every finished stream equals the oracle's, the autoscaler backfills,
    and both SLO burn rates stay below 1.  The kill lands at 0.02 s, not
    the reference's 0.5 s: the port replays these 10 arrivals (about
    0.05 s of arrival times at rate 200) in under 0.5 s, so a kill at
    0.5 s would find the replay over."""
    proc = run_cli(
        "--device", "cpu", "--replicas", "2", "--verify", "--autoscale",
        "--traffic", ("rate=200,requests=10,abusive_frac=0.2,"
                      "prompt_buckets=4-8:0.6|10-20:0.4,"
                      "output_buckets=4-8:0.7|10-16:0.3"),
        "--chaos", "kill:replica=1:at=0.02",
        "--slo", "queue=30,decode=30",
        "--vocab", "64", "--d-model", "16", "--d-ff", "32",
        "--max-len", "64", "--block-size", "4", "--n-blocks", "64")
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = reports(proc)["local"]
    assert out["parity"] == "ok"
    traffic = out["traffic"]
    assert traffic["finished"] == traffic["offered"]
    assert any(ev["action"] == "spawn" and ev["reason"] == "backfill"
               for ev in traffic["autoscaler_events"])
    assert set(traffic["burn_rates"]) == {"queue", "decode"}
    assert all(v < 1.0 for v in traffic["burn_rates"].values())


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a card")
@pytest.mark.parametrize("argv", [[], ["--groups", "2"],
                                  ["--role", "replica"]],
                         ids=["local", "launcher", "replica"])
def test_cli_refuses_without_card_unless_cpu(argv):
    """With no card and no ``--device cpu`` every role exits non-zero
    before building anything, naming the flag; nothing falls back to the
    CPU."""
    proc = run_cli(*argv)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert not proc.stdout.strip()
