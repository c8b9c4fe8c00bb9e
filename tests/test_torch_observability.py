"""The port's host telemetry (``observability``: reporter, spans, step
log, tracing) against the reference's: the same calls on both give the
same summaries, rows, span trees and gauges."""

import pytest

from chainermn_tpu.observability import reporter as jrep
from chainermn_tpu.observability import step_log as jlog
from chainermn_tpu.observability import tracing as jtr
from chainermn_tpu_torch.observability import reporter as trep
from chainermn_tpu_torch.observability import spans as tspans
from chainermn_tpu_torch.observability import step_log as tlog
from chainermn_tpu_torch.observability import tracing as ttr


def _drive_reporter(m):
    r = m.Reporter()
    for i in range(5):
        r.observe("loss", 1.0 / (i + 1))
        r.count("steps")
        r.histogram_observe("dt", 0.001 * 3 ** i)
        r.gauge("queue", i)
    r.observe("serving/x/replica/3", 1.0)
    r.count("serving/y/replica/3/z", 2)
    dropped = r.forget_replica(3)
    r.report({"acc": 0.5})
    other = m.Reporter()
    other.gauge("queue", 10)
    other.count("steps", 3)
    return (r.summary(), dropped,
            m.merge_summaries([r.summary(), other.summary()]))


def test_reporter_matches_reference():
    assert _drive_reporter(trep) == _drive_reporter(jrep)


def test_span_publishes_to_the_current_reporter():
    r = trep.Reporter()
    assert not tspans.telemetry_active()
    with trep.scope(r):
        assert tspans.telemetry_active()
        with tspans.span("work"):
            pass
        with pytest.raises(RuntimeError):
            with tspans.span("bad"):
                raise RuntimeError("x")
    s = r.summary()
    assert s["scalars"]["span/work"]["count"] == 1
    assert s["counters"]["span/bad/errors"] == 1
    assert trep.get_reporter() is None


def test_step_log_rows_rotation_and_truncated_line(tmp_path):
    rows = {}
    for name, m in (("ref", jlog), ("port", tlog)):
        path = tmp_path / f"{name}.jsonl"
        kw = {"capture_compile_events": False} if m is jlog else {}
        clock = iter(float(i) for i in range(100))
        rec = m.StepRecorder(str(path), rotate_bytes=300, max_files=2,
                             mem_every=0, clock=lambda: next(clock), **kw)
        for i in range(6):
            rec.add_span("fwd", 0.5)
            rec.step(items=10, loss=1.0 / (i + 1))
        rec.record("evt", note="x")
        rec.close()
        with open(path, "ab") as f:
            f.write(b'{"event": "step", "trunc')     # a SIGKILL mid-write
        got = m.read_records(str(path))
        for r in got:
            r.pop("t")
        rows[name] = got
    assert rows["port"] == rows["ref"]
    assert rows["port"][-1]["event"] == "evt"


def _drive_tracer(m, path):
    t = [100.0]
    flight = m.FlightRecorder(str(path), replica=0)
    rep = (trep if m is ttr else jrep).Reporter()
    tr = m.Tracer(flight=flight, reporter=rep, replica=0,
                  slo=m.SLOConfig(targets={"decode": 0.5}, window=4),
                  clock=lambda: t[0], nonce="n")
    with m.trace_scope(tr):
        assert m.get_tracer() is tr
        root = tr.begin("request", tenant="ta")
        with tr.span("prefill", parent=root):
            t[0] += 0.25
        for k in range(3):
            tr.record_span("decode", root, t[0], 0.2 * (k + 1),
                           attrs_k=k)
            tr.token(root)
            t[0] += 0.5
        tr.event("preempted", root, reason="pool")
        with pytest.raises(ValueError):
            with tr.span("handoff", parent=root):
                raise ValueError("boom")
        tr.end(root)
        tr.end(root)                                   # double-end safe
    assert m.get_tracer() is None
    flight.close()
    recs = tr.records()
    on_disk = m.read_flight(str(path))
    for r in on_disk:
        r.pop("t", None)
        r.pop("rank", None)
    trees = m.stitch(recs)
    (tid, tree), = trees.items()
    return dict(
        recs=recs, disk=on_disk, stitched=trees,
        valid=m.validate_trace(tree["spans"]),
        gauges=rep.summary()["gauges"],
        histograms=rep.summary()["histograms"], open=tr.open_count())


def test_tracing_matches_reference(tmp_path):
    port = _drive_tracer(ttr, tmp_path / "p.jsonl")
    ref = _drive_tracer(jtr, tmp_path / "r.jsonl")
    assert port == ref
    assert port["valid"]["connected"] and port["valid"]["monotone"]
    assert "slo/burn_rate/decode" in port["gauges"]
    assert ttr.SpanCtx.from_wire({"tid": "a", "sid": "b"}).to_wire() == \
        {"tid": "a", "sid": "b"}
