"""The port's postmortem and live-metrics tools (``tools/obs``,
``observability.exporter``, ``observability.anomaly`` and the tracing
exports) against the JAX package, on the CPU.

``summarize``, ``to_prometheus``, ``metric_diff``, ``trace_report``,
``read_flight_dir``, ``stage_percentiles`` and the anomaly detector equal
the reference's on the same rows; the Prometheus golden of
``tests/test_observability.py`` and the Chrome-trace golden
``tests/golden/serve_trace.json`` hold as they are; a live exporter's
counters move between scrapes; and the obs CLI runs as a subprocess.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import pytest

from chainermn_tpu.observability import anomaly as janomaly
from chainermn_tpu.observability import reporter as jreporter
from chainermn_tpu.observability import tracing as jtracing
from chainermn_tpu.tools import obs as jobs
from chainermn_tpu_torch.observability import (
    AnomalyDetector,
    FlightRecorder,
    MetricsExporter,
    Reporter,
    Tracer,
    read_flight_dir,
    read_records,
    stage_percentiles,
    to_chrome_trace,
)
from chainermn_tpu_torch.tools import obs
from test_observability import _CLI_ROWS, PROM_GOLDEN, _fleet_summary

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
SERVE_GOLDEN = os.path.join(HERE, "golden", "serve_trace.json")


def _write_rows(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def serve_records():
    """The reference's deterministic disagg-shaped request
    (``test_tracing._synthetic_serve_records``) through the port's
    Tracer: fixed clock and nonce make every id and timestamp
    reproducible."""
    clock = {"t": 1000.0}

    def tick():
        clock["t"] += 0.001
        return clock["t"]

    tr = Tracer(clock=tick, nonce="g", replica="router")
    root = tr.begin("request", rid=0, prompt_len=9, max_new_tokens=3)
    tr.record_span("placement", root, 1000.002, 0.001,
                   replica="router", target=0, kind="prefill")
    tr.record_span("queue", root, 1000.003, 0.004, replica=0, depth=1)
    tr.record_span("prefill_chunk", root, 1000.005, 0.002, replica=0,
                   tokens=4, pos=4, total=9)
    tr.record_span("prefill", root, 1000.008, 0.050, replica=0,
                   tokens=9, disagg=True)
    tr.record_span("handoff", root, 1000.060, 0.010, replica=1,
                   tokens=10)
    tr.event("preempted", root, replica=1, generated=1)
    tr.token(root)
    tr.record_span("decode", root, 1000.080, 0.005, replica=1, batch=2)
    tr.token(root)
    tr.record_span("draft", root, 1000.088, 0.001, replica=1,
                   source="model", draft=2)
    tr.record_span("speculate", root, 1000.089, 0.001, replica=1,
                   draft=2)
    tr.record_span("verify", root, 1000.090, 0.005, replica=1, batch=2,
                   accepted=1)
    tr.token(root)
    tr.end(root, status="finished", tokens=3)
    return tr.records()


def _rank_rows():
    single = [{"event": "step", "rank": 0, "step": i, "loss": float(10 - i),
               "dt": 0.5, "items": 8} for i in range(40)]
    return single + [dict(r, rank=1) for r in single]


def _metric_rows():
    rows = [{"event": "gauge", "rank": r, "name": n, "value": v}
            for r in (0, 1)
            for n, v in (("serving/running/replica/r0", 2 + r),
                         ("serving/queue_depth", 4 * r),
                         ("serving/free_blocks/replica/1", 60.0))]
    rows += [{"event": "counter", "rank": r, "name": "elastic/restarts",
              "value": 1 + r} for r in (0, 1)]
    return rows


ROW_SETS = {
    "cli": lambda: list(_CLI_ROWS),
    "ranks": _rank_rows,
    "metrics": _metric_rows,
    "serve_trace": lambda: serve_records() + [
        {"event": "span", "trace": "tg.2", "span": "x1", "parent": "g.1",
         "name": "decode", "t0": 1000.1, "dur": 0.004, "replica": 0}],
}


@pytest.mark.parametrize("rows", list(ROW_SETS))
def test_summarize_and_prometheus_equal_reference(rows, tmp_path):
    """The same JSONL rows, read back by each package's step-log reader:
    ``summarize`` and ``to_prometheus`` (default and custom prefix) equal
    the reference's."""
    p = tmp_path / "log.jsonl"
    _write_rows(p, ROW_SETS[rows]())
    mine = obs.summarize(read_records(str(p)), curve_points=8)
    ref = jobs.summarize(jobs._load([str(p)]), curve_points=8)
    assert mine == ref
    assert obs.to_prometheus(mine) == jobs.to_prometheus(ref)
    assert obs.to_prometheus(mine, prefix="t") == \
        jobs.to_prometheus(ref, prefix="t")


def test_prometheus_golden(tmp_path):
    p = tmp_path / "log.jsonl"
    _write_rows(p, _CLI_ROWS)
    assert obs.to_prometheus(obs.summarize(read_records(str(p))),
                             prefix="t") == PROM_GOLDEN


def test_native_histograms_and_replica_labels_equal_reference():
    """Pow2 histograms and per-replica series render as the reference's
    registry renders the same observations."""
    mine, ref = Reporter(), jreporter.Reporter()
    for r in (mine, ref):
        for v in (0.75, 3.0, 3.5, 0.0):
            r.histogram_observe("trace/decode", v)
        r.histogram_observe("trace/decode/replica/3", 2.0)
        r.gauge("serving/running/replica/r0", 2)
        r.count("serving/steps", 5)
    text = obs.to_prometheus(mine.summary())
    assert text == jobs.to_prometheus(ref.summary())
    assert "# TYPE chainermn_tpu_histogram histogram" in text
    assert 'name="trace/decode",replica="3"' in text


def test_replica_gauges_prometheus_labels():
    """The Prometheus half of the reference's
    ``test_replica_gauges_and_prometheus_labels``: a replica's gauges
    split their replica id into a label; bare names stay unsuffixed."""
    import torch

    from chainermn_tpu_torch.models.transformer import TransformerLM
    from chainermn_tpu_torch.serving import EngineConfig, InferenceEngine
    from chainermn_tpu_torch.serving.cluster import Replica

    rep = Reporter()
    lm = TransformerLM(vocab=32, d_model=16, n_heads=2, d_ff=32,
                       n_layers=2, max_len=64, dtype=torch.float32,
                       device="cpu")
    eng = InferenceEngine(lm, EngineConfig(block_size=4, n_blocks=64,
                                           max_len=64, max_batch=4),
                          device="cpu")
    replica = Replica("r0", eng, reporter=rep)
    h = replica.frontend.submit([1, 2, 3, 4, 5], 4)
    while not h.done:
        replica.step()
    g = rep.summary()["gauges"]
    assert g["serving/running/replica/r0"]["value"] == 0
    assert g["serving/free_blocks/replica/r0"]["value"] == 64
    assert "serving/running" not in g
    text = obs.to_prometheus(rep.summary())
    assert 'chainermn_tpu_gauge{name="serving/running",replica="r0"} 0' \
        in text
    summary = {"gauges": {
        "serving/running/replica/r0": {"sum": 2.0, "max": 2.0},
        "serving/running": {"sum": 1.0, "max": 1.0},
    }}
    prom = obs.to_prometheus(summary)
    assert prom == jobs.to_prometheus(summary)
    assert ('chainermn_tpu_gauge{name="serving/running",'
            'replica="r0"} 2' in prom)
    assert 'chainermn_tpu_gauge{name="serving/running"} 1' in prom


def test_chrome_trace_golden():
    with open(SERVE_GOLDEN) as f:
        want = json.load(f)
    recs = serve_records()
    assert to_chrome_trace(recs) == want
    assert jtracing.to_chrome_trace(recs) == want


def test_flight_dir_and_stage_percentiles_equal_reference(tmp_path):
    """Flight files of a router and two replicas (one rotated, one with a
    torn last line as a SIGKILL leaves it): both packages read the same
    rows in the same order and compute the same stage table."""
    recs = serve_records()
    by_rep = {}
    for r in recs:
        by_rep.setdefault(str(r.get("replica")), []).append(r)
    for rep, rows in by_rep.items():
        fr = FlightRecorder(str(tmp_path / f"flight_{rep}.jsonl"),
                            replica=rep, rotate_bytes=400, max_files=8)
        for r in rows:
            row = {k: v for k, v in r.items() if k != "event"}
            fr.write(r["event"], row)
        fr.close()
    with open(tmp_path / "flight_1.jsonl", "a") as f:
        f.write('{"event": "span", "trace": "g.1", "na')
    pattern = str(tmp_path / "flight_*.jsonl")
    mine = read_flight_dir(pattern)
    assert mine == jtracing.read_flight_dir(pattern)
    assert len(mine) == len(recs)
    assert stage_percentiles(mine) == jtracing.stage_percentiles(mine)
    assert stage_percentiles(recs)["verify"]["count"] == 1


@pytest.mark.parametrize("stats", [False, True], ids=["chrome", "stats"])
def test_trace_report_equals_reference(stats):
    rows = serve_records()
    assert obs.trace_report(rows, stats=stats) == \
        jobs.trace_report(rows, stats=stats)


@pytest.mark.parametrize("pair", [
    ({"latency_p99_s": 1.0, "tokens_per_sec": 100.0, "widgets": 3.0},
     {"latency_p99_s": 1.5, "tokens_per_sec": 100.0, "widgets": 4.0}),
    ({"goodput_tps": 100.0}, {"goodput_tps": 80.0}),
    ({"serving": {"latency_p99_s": 1.0, "goodput_tps": 50.0, "ok": True,
                  "curve": [1, 2]}},
     {"serving": {"latency_p99_s": 0.5, "goodput_tps": 50.0, "ok": False,
                  "curve": [1, 3], "new": 1}}),
], ids=["latency", "throughput", "nested"])
def test_metric_diff_equals_reference(pair):
    a, b = pair
    for t in (0.05, 0.5):
        assert obs.metric_diff(a, b, threshold=t) == \
            jobs.metric_diff(a, b, threshold=t)
        assert obs.metric_diff(b, a, threshold=t) == \
            jobs.metric_diff(b, a, threshold=t)


def _scrape(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read().decode()


def test_metrics_exporter_scrape_counters_move():
    r = Reporter()
    r.count("serving/steps", 3)
    exp = MetricsExporter(r, port=0)
    port = exp.start()
    try:
        assert exp.url == f"http://127.0.0.1:{port}/metrics"
        assert exp.start() == port
        t1 = _scrape(exp.url)
        assert 'chainermn_tpu_counter_total{name="serving/steps"} 3' in t1
        r.count("serving/steps", 2)
        r.gauge("serving/queue_depth", 4)
        t2 = _scrape(exp.url)
        assert 'chainermn_tpu_counter_total{name="serving/steps"} 5' in t2
        assert 'chainermn_tpu_gauge{name="serving/queue_depth"} 4' in t2
        assert t2 == exp.render()
    finally:
        exp.stop()
    exp.stop()


def test_metrics_exporter_callable_source_and_404():
    calls = []

    def source():
        calls.append(1)
        return {"counters": {"fleet/scrapes": len(calls)}}

    with MetricsExporter(source, port=0) as exp:
        assert 'name="fleet/scrapes"} 1' in _scrape(exp.url)
        assert 'name="fleet/scrapes"} 2' in _scrape(exp.url)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(
                exp.url.replace("/metrics", "/nope"), timeout=10)
        assert ei.value.code == 404
    with pytest.raises(TypeError):
        MetricsExporter(42)


def _latency_trace():
    hist, out = {0: 0}, []
    for i in range(6):
        hist[0] += 1
        out.append(_fleet_summary(0, dict(hist)))
    hist[3] = 0
    for i in range(3):
        hist[3] += 1
        out.append(_fleet_summary(0, dict(hist)))
    for i in range(6):
        hist[0] += 1
        out.append(_fleet_summary(0, dict(hist)))
    return out


def _goodput_trace():
    tokens, out = 0.0, []
    for step in [100.0] * 6 + [10.0] * 2 + [-500.0] + [100.0] * 4:
        tokens += step
        out.append(_fleet_summary(tokens))
    return out


@pytest.mark.parametrize("trace", ["latency", "goodput"])
def test_anomaly_detector_equals_reference(trace):
    """Both detectors fold the same fleet summaries: every update's state
    and ratios, and the published ``anomaly/*`` series, are equal."""
    fleets = (_latency_trace if trace == "latency" else _goodput_trace)()
    kw = dict(window=2, baseline=8, min_samples=2, regression_factor=2.0,
              drop_factor=0.5)
    mine_rep, ref_rep = Reporter(), jreporter.Reporter()
    mine = AnomalyDetector(reporter=mine_rep, **kw)
    ref = janomaly.AnomalyDetector(reporter=ref_rep, **kw)
    alarms = 0
    for i, f in enumerate(fleets):
        assert mine.update(f, now=float(i)) == ref.update(f, now=float(i))
        assert mine.alarming() == ref.alarming()
        alarms += mine.alarming()
    assert alarms > 0
    a, b = mine_rep.summary(), ref_rep.summary()
    assert a["counters"] == b["counters"]
    assert {k: v["value"] for k, v in a["gauges"].items()} == \
        {k: v["value"] for k, v in b["gauges"].items()}


def test_anomaly_source_callable_and_no_source_error():
    with pytest.raises(ValueError):
        AnomalyDetector().update()
    fleet = {"n": 0.0}

    def source():
        fleet["n"] += 50.0
        return _fleet_summary(fleet["n"])

    det = AnomalyDetector(source=source, window=2, baseline=8,
                          min_samples=2)
    for i in range(4):
        det.update(now=float(i))
    assert not det.alarming()


def test_obs_cli_subprocess(tmp_path):
    """``python -m chainermn_tpu_torch.tools.obs``: summarize prints the
    reference's summary, prom writes the golden textfile, trace writes
    the reference's Chrome JSON and stats, diff gates a regression."""
    log = tmp_path / "log.jsonl"
    _write_rows(log, _CLI_ROWS)
    flight = tmp_path / "flight.jsonl"
    _write_rows(flight, serve_records())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)

    def run(*argv):
        return subprocess.run(
            [sys.executable, "-m", "chainermn_tpu_torch.tools.obs", *argv],
            capture_output=True, text=True, timeout=60, env=env)

    out = run("summarize", str(log))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == json.loads(json.dumps(
        jobs.summarize(jobs._load([str(log)]))))
    prom = tmp_path / "log.prom"
    out = run("prom", str(log), "-o", str(prom), "--prefix", "t")
    assert out.returncode == 0, out.stderr
    assert prom.read_text() == PROM_GOLDEN
    out = run("trace", str(flight))
    assert out.returncode == 0, out.stderr
    assert out.stdout == jobs.trace_report(serve_records())
    out = run("trace", str(flight), "--stats")
    assert out.stdout == jobs.trace_report(serve_records(), stats=True)
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    a.write_text(json.dumps({"serving": {"latency_p99_s": 1.0}}))
    b.write_text(json.dumps({"serving": {"latency_p99_s": 2.0}}))
    assert run("diff", str(a), str(b), "--threshold", "0.1").returncode == 1
    assert run("diff", str(a), str(a)).returncode == 0
