"""Step-event log summarizer/exporter CLI — port of
``chainermn_tpu/tools/obs.py`` (host code, copied as it is; its output is
the reference's, metric names and the ``chainermn_tpu`` prefix included,
so one dashboard reads either package's logs).

Reads one or more JSONL step-event logs written by
``chainermn_tpu_torch.observability.StepRecorder`` (rotated segments included,
truncated crash tails skipped) and either prints a JSON summary or
exports Prometheus textfile metrics.

Usage::

    # one JSON object: steps/sec, loss curve, span totals, compile
    # events, collective counts (multi-rank logs aggregate per step):
    python -m chainermn_tpu_torch.tools.obs summarize steps.jsonl

    # several ranks' logs together (values rank-aggregate):
    python -m chainermn_tpu_torch.tools.obs summarize r0.jsonl r1.jsonl

    # Prometheus textfile (node_exporter textfile-collector format):
    python -m chainermn_tpu_torch.tools.obs prom steps.jsonl -o steps.prom

    # Chrome-trace/Perfetto JSON from serving flight-recorder logs
    # (stitches span rows across router + replica files; load the
    # output in chrome://tracing or ui.perfetto.dev):
    python -m chainermn_tpu_torch.tools.obs trace flight_r*.jsonl -o trace.json

    # postmortem stats instead: per-stage p50/p99, per-trace
    # connectivity/orphan validation, straggler report:
    python -m chainermn_tpu_torch.tools.obs trace flight_r*.jsonl --stats

The summary's rank aggregation mirrors the Reporter's reductions: losses
average across ranks per step (each rank already logs the pmean'd global
loss, so the aggregate of N rank logs matches a single-process run),
counters and span durations sum, step timing averages.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List


def _load(paths, include_rotated=True) -> List[dict]:
    from ..observability.step_log import read_records

    rows: List[dict] = []
    for p in paths:
        rows.extend(read_records(p, include_rotated=include_rotated))
    return rows


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def summarize(rows: List[dict], curve_points: int = 16) -> dict:
    """Pure aggregation over parsed rows — the CLI's engine, exposed for
    tests and in-process use."""
    events: Dict[str, int] = {}
    for r in rows:
        e = r.get("event", "?")
        events[e] = events.get(e, 0) + 1

    steps = [r for r in rows if r.get("event") == "step"]
    ranks = sorted({int(r.get("rank", 0)) for r in rows})
    n_ranks = max(1, len(ranks))

    # Per-(step index) rank aggregation: mean loss/dt across ranks.
    by_step: Dict[int, List[dict]] = {}
    for r in steps:
        by_step.setdefault(int(r.get("step", 0)), []).append(r)

    def rank_mean(rs, key):
        vs = [float(r[key]) for r in rs if key in r]
        return sum(vs) / len(vs) if vs else None

    step_ids = sorted(by_step)
    dts = [d for s in step_ids
           if (d := rank_mean(by_step[s], "dt")) is not None]
    losses = [(s, l) for s in step_ids
              if (l := rank_mean(by_step[s], "loss")) is not None]
    items = sum(r.get("items", 0) for r in steps) / n_ranks

    out: dict = {"rows": len(rows), "events": events, "ranks": ranks}
    summary_steps: dict = {"count": len(step_ids)}
    if dts:
        wall = sum(dts)
        summary_steps.update(
            wall_s=wall,
            mean_dt_s=wall / len(dts),
            median_dt_s=_median(dts),
            per_sec=len(dts) / wall if wall > 0 else 0.0,
        )
        if items:
            summary_steps["items_per_sec"] = items / wall if wall else 0.0
    out["steps"] = summary_steps

    if losses:
        stride = max(1, -(-len(losses) // curve_points))
        curve = losses[::stride]
        if curve[-1] != losses[-1]:
            curve.append(losses[-1])
        out["loss"] = {
            "first": losses[0][1],
            "last": losses[-1][1],
            "min": min(l for _, l in losses),
            "curve": [[s, l] for s, l in curve],
        }

    spans: Dict[str, dict] = {}
    for r in steps:
        for name, secs in (r.get("spans") or {}).items():
            d = spans.setdefault(name, {"total_s": 0.0, "count": 0})
            d["total_s"] += float(secs)
            d["count"] += 1
    if spans:
        out["spans"] = spans

    compiles = [r for r in rows if r.get("event") == "compile"]
    if compiles:
        out["compile"] = {
            "count": len(compiles),
            "total_s": sum(float(r.get("secs", 0.0)) for r in compiles),
        }

    gauge_rows = [r for r in rows if r.get("event") == "gauge"
                  and "name" in r]
    if gauge_rows:
        # Reporter.gauge semantics: last value wins per (rank, name) in
        # file order; ranks then merge to sum with min/max spread.
        last: Dict[tuple, float] = {}
        for r in gauge_rows:
            last[(int(r.get("rank", 0)), str(r["name"]))] = \
                float(r.get("value", 0.0))
        gauges: Dict[str, dict] = {}
        for (_, name), v in last.items():
            d = gauges.setdefault(
                name, {"sum": 0.0, "min": v, "max": v, "n": 0}
            )
            d["sum"] += v
            d["min"] = min(d["min"], v)
            d["max"] = max(d["max"], v)
            d["n"] += 1
        out["gauges"] = gauges

    counter_rows = [r for r in rows if r.get("event") == "counter"
                    and "name" in r]
    if counter_rows:
        # Monotonic counters (the elastic supervisor's elastic/restarts,
        # elastic/preemptions, elastic/resume_generation): last value
        # wins per (rank, name) — each row is the counter's current
        # total, not an increment — then ranks sum.
        clast: Dict[tuple, float] = {}
        for r in counter_rows:
            clast[(int(r.get("rank", 0)), str(r["name"]))] = \
                float(r.get("value", 0.0))
        counters: Dict[str, float] = {}
        for (_, name), v in clast.items():
            counters[name] = counters.get(name, 0.0) + v
        out["counters"] = counters

    span_rows = [r for r in rows if r.get("event") == "span"
                 and "dur" in r and "name" in r]
    if span_rows:
        from ..observability.tracing import percentile

        stages: Dict[str, dict] = {}
        for r in span_rows:
            d = stages.setdefault(
                str(r["name"]),
                {"durs": [], "by_replica": {}},
            )
            d["durs"].append(float(r["dur"]))
            d["by_replica"].setdefault(
                str(r.get("replica")), []
            ).append(float(r["dur"]))

        def _pcts(durs):
            return {
                "count": len(durs),
                "p50_s": percentile(durs, 50),
                "p99_s": percentile(durs, 99),
            }

        out["trace_stages"] = {
            name: {
                **_pcts(d["durs"]),
                "by_replica": {
                    rid: _pcts(ds)
                    for rid, ds in sorted(d["by_replica"].items())
                },
            }
            for name, d in sorted(stages.items())
        }
        out["traces"] = len({r.get("trace") for r in span_rows})

    audits = [r for r in rows if r.get("event") == "hlo_audit"]
    if audits:
        counts: Dict[str, int] = {}
        per_axis: Dict[str, int] = {}
        for r in audits:
            for k, v in (r.get("counts") or {}).items():
                counts[k] = counts.get(k, 0) + int(v)
            for k, v in (r.get("bytes_per_axis") or {}).items():
                per_axis[k] = per_axis.get(k, 0) + int(v)
        # An audit is a static property of the step program: every rank
        # logs the same census, so report the per-rank view.
        n_audit_ranks = max(
            1, len({int(r.get("rank", 0)) for r in audits})
        )
        out["collectives"] = {
            "counts": {k: v // n_audit_ranks for k, v in counts.items()},
            "bytes_per_axis": {
                k: v // n_audit_ranks for k, v in per_axis.items()
            },
        }
    return out


def _fmt(v: float) -> str:
    return f"{float(v):.10g}"


def to_prometheus(summary: dict, prefix: str = "chainermn_tpu") -> str:
    """Render a summary as Prometheus textfile metrics (deterministic
    ordering — fit for golden-file tests and textfile collectors)."""
    lines: List[str] = []
    emitted_headers: set = set()

    def metric(name, mtype, help_, samples):
        # Prometheus exposition format allows each metric's HELP/TYPE
        # header at most once per scrape: repeated metric() calls for
        # the same name (e.g. per-replica labelled series emitted from
        # several sections) append samples without re-emitting headers.
        if name not in emitted_headers:
            emitted_headers.add(name)
            lines.append(f"# HELP {prefix}_{name} {help_}")
            lines.append(f"# TYPE {prefix}_{name} {mtype}")
        for labels, value in samples:
            lab = (
                "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"
                if labels else ""
            )
            lines.append(f"{prefix}_{name}{lab} {_fmt(value)}")

    st = summary.get("steps", {})
    metric("steps_total", "counter", "Training steps recorded",
           [((), st.get("count", 0))])
    if "wall_s" in st:
        metric("step_seconds_sum", "counter",
               "Sum of host-side step durations", [((), st["wall_s"])])
        metric("step_seconds_mean", "gauge", "Mean step duration",
               [((), st["mean_dt_s"])])
        metric("steps_per_second", "gauge", "Steps per second",
               [((), st["per_sec"])])
    if "items_per_sec" in st:
        metric("items_per_second", "gauge",
               "Items (tokens or images) per second",
               [((), st["items_per_sec"])])
    loss = summary.get("loss")
    if loss:
        metric("loss_last", "gauge", "Last recorded loss",
               [((), loss["last"])])
        metric("loss_min", "gauge", "Minimum recorded loss",
               [((), loss["min"])])
    comp = summary.get("compile")
    if comp:
        metric("compile_events_total", "counter",
               "jax.monitoring compile events", [((), comp["count"])])
        metric("compile_seconds_total", "counter",
               "Total compile seconds", [((), comp["total_s"])])
    spans = summary.get("spans")
    if spans:
        metric("span_seconds_total", "counter",
               "Host-side span durations",
               [((("span", k),), v["total_s"])
                for k, v in sorted(spans.items())])
    gauges = summary.get("gauges")
    if gauges:
        # Per-replica serving gauges ("serving/running/replica/<id>", as
        # a multi-replica tier's schedulers publish them) split the
        # replica id into its own label so a fleet scrapes cleanly:
        # one metric name, N labeled series.
        def gauge_labels(name):
            base, sep, rid = name.rpartition("/replica/")
            if sep and rid:
                return (("name", base), ("replica", rid))
            return (("name", name),)

        samples = sorted(
            (gauge_labels(k), v) for k, v in gauges.items()
        )
        metric("gauge", "gauge",
               "Set-style gauges, last value per rank summed across ranks",
               [(labels, v["sum"]) for labels, v in samples])
        metric("gauge_max", "gauge",
               "Most-loaded rank's value per set-style gauge",
               [(labels, v["max"]) for labels, v in samples])
    counters = summary.get("counters")
    if counters:
        metric("counter_total", "counter",
               "Named counters, last value per rank summed across ranks",
               [(((("name", k),)), v)
                for k, v in sorted(counters.items())])
    hists = summary.get("histograms")
    if hists:
        # Native Prometheus histogram exposition from the Reporter's
        # power-of-two buckets: bucket b covers (2^(b-1), 2^b], so every
        # upper bound is an exact le=2^b boundary.  Counts are cumulative
        # per the exposition rules; _sum is the upper-bound estimate —
        # the tightest sum a bucketed-only registry can offer.
        lines.append(f"# HELP {prefix}_histogram "
                     "Power-of-two histograms (bucket b covers "
                     "(2^(b-1), 2^b])")
        lines.append(f"# TYPE {prefix}_histogram histogram")

        def hist_labels(name):
            base, sep, rid = name.rpartition("/replica/")
            if sep and rid:
                return f'name="{base}",replica="{rid}"'
            return f'name="{name}"'

        for hname, bucketed in sorted(hists.items()):
            lab = hist_labels(hname)
            cum = 0
            total = 0.0
            for b, c in sorted((int(b), int(c))
                               for b, c in bucketed.items()):
                cum += c
                total += c * (2.0 ** b)
                lines.append(
                    f'{prefix}_histogram_bucket{{{lab},'
                    f'le="{_fmt(2.0 ** b)}"}} {cum}'
                )
            lines.append(
                f'{prefix}_histogram_bucket{{{lab},le="+Inf"}} {cum}'
            )
            lines.append(f"{prefix}_histogram_sum{{{lab}}} {_fmt(total)}")
            lines.append(f"{prefix}_histogram_count{{{lab}}} {cum}")
    tstages = summary.get("trace_stages")
    if tstages:
        # Per-stage series overall ({stage="decode"}) AND per replica
        # ({stage="decode",replica="1"}) — mixed label sets under one
        # metric name are valid exposition format.
        def trace_rows(key):
            rows = []
            for stage, d in sorted(tstages.items()):
                rows.append(((("stage", stage),), d[key]))
                for rid, rd in sorted(d["by_replica"].items()):
                    rows.append(
                        ((("stage", stage), ("replica", rid)), rd[key])
                    )
            return rows

        metric("trace_spans_total", "counter",
               "Trace spans recorded per serving stage",
               trace_rows("count"))
        metric("trace_stage_p50_seconds", "gauge",
               "Per-stage span duration p50 derived from traces",
               trace_rows("p50_s"))
        metric("trace_stage_p99_seconds", "gauge",
               "Per-stage span duration p99 derived from traces",
               trace_rows("p99_s"))
        if "traces" in summary:
            metric("traces_total", "counter",
                   "Distinct request traces in the log window",
                   [((), summary["traces"])])
    coll = summary.get("collectives")
    if coll:
        metric("collective_ops_total", "counter",
               "Collective primitives in the audited step program",
               [((("primitive", k),), v)
                for k, v in sorted(coll["counts"].items())])
        metric("collective_operand_bytes", "gauge",
               "Per-device collective operand bytes per mesh axis",
               [((("axis", k),), v)
                for k, v in sorted(coll["bytes_per_axis"].items())])
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Metric regression gate (``obs diff``)
# ---------------------------------------------------------------------------
# Direction heuristics on flattened key paths: which way is "worse".
# Checked in order — a higher-is-better match wins over lower-is-better
# so e.g. "tokens_per_sec" is not misread by its "_s" suffix.
_HIGHER_BETTER = (
    "per_sec", "per_second", "tokens_per_sec", "goodput", "throughput",
    "accuracy", "hit_rate", "accept_len", "capacity", "finished",
    "free_blocks", "improvement", "speedup",
)
_LOWER_BETTER = (
    "p99", "p95", "p50", "latency", "seconds", "_s", "_ms", "err",
    "loss", "shed", "rejected", "preempt", "violation", "burn",
    "compile", "dur", "orphan", "restarts", "dropped",
)


def _direction(path: str):
    low = path.lower()
    if any(t in low for t in _HIGHER_BETTER):
        return "higher_better"
    if any(t in low for t in _LOWER_BETTER):
        return "lower_better"
    return None


def _flatten(obj, prefix="") -> Dict[str, float]:
    out: Dict[str, float] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            out.update(_flatten(v, f"{prefix}{i}."))
    elif isinstance(obj, bool):
        pass  # booleans are not metrics
    elif isinstance(obj, (int, float)):
        out[prefix[:-1]] = float(obj)
    return out


def metric_diff(a: dict, b: dict, threshold: float = 0.05) -> dict:
    """Compare two JSON metric reports (bench output, ``summarize``
    output, Reporter summaries).  Numeric leaves are flattened to dotted
    paths; a leaf whose path matches a direction heuristic and moved the
    wrong way by more than ``threshold`` (relative) is a regression.
    Directionless leaves are reported as ``changed`` but never gate."""
    fa, fb = _flatten(a), _flatten(b)
    regressions, improvements, changed = [], [], []
    for path in sorted(fa.keys() & fb.keys()):
        va, vb = fa[path], fb[path]
        if va == vb:
            continue
        rel = (vb - va) / abs(va) if va != 0 else math.inf
        row = {"key": path, "a": va, "b": vb,
               "rel_change": None if math.isinf(rel) else rel}
        direction = _direction(path)
        if direction is None:
            changed.append(row)
            continue
        worse = rel > threshold if direction == "lower_better" \
            else rel < -threshold
        better = rel < -threshold if direction == "lower_better" \
            else rel > threshold
        row["direction"] = direction
        if worse:
            regressions.append(row)
        elif better:
            improvements.append(row)
        else:
            changed.append(row)
    return {
        "threshold": threshold,
        "compared": len(fa.keys() & fb.keys()),
        "only_a": sorted(fa.keys() - fb.keys()),
        "only_b": sorted(fb.keys() - fa.keys()),
        "regressions": regressions,
        "improvements": improvements,
        "changed": changed,
        "ok": not regressions,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m chainermn_tpu_torch.tools.obs",
        description="Summarize/export StepRecorder JSONL logs.",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summarize", help="print one JSON summary object")
    s.add_argument("logs", nargs="+", help="JSONL log path(s), one per rank")
    s.add_argument("--no-rotated", action="store_true",
                   help="ignore rotated .N segments")
    s.add_argument("--curve-points", type=int, default=16,
                   help="max loss-curve samples in the summary")

    p = sub.add_parser("prom", help="export Prometheus textfile metrics")
    p.add_argument("logs", nargs="+")
    p.add_argument("-o", "--output", default=None,
                   help="output path (default: stdout)")
    p.add_argument("--prefix", default="chainermn_tpu")
    p.add_argument("--no-rotated", action="store_true")

    t = sub.add_parser(
        "trace",
        help="stitch flight-recorder logs into Chrome-trace JSON",
    )
    t.add_argument("logs", nargs="+",
                   help="flight JSONL path(s) — router + replicas")
    t.add_argument("-o", "--output", default=None,
                   help="output path (default: stdout)")
    t.add_argument("--stats", action="store_true",
                   help="print per-stage percentiles, per-trace "
                        "validation, and a straggler report instead of "
                        "the Chrome JSON")
    t.add_argument("--straggler-k", type=float, default=4.0,
                   help="flag replicas whose stage median exceeds this "
                        "multiple of the fleet median")
    t.add_argument("--no-rotated", action="store_true")

    d = sub.add_parser(
        "diff",
        help="regression gate between two JSON metric reports "
             "(e.g. BENCH_*.json pairs): exit 1 on regressions past "
             "--threshold",
    )
    d.add_argument("a", help="baseline JSON report")
    d.add_argument("b", help="candidate JSON report")
    d.add_argument("--threshold", type=float, default=0.05,
                   help="relative change gating a directional metric "
                        "(default 0.05 = 5%%)")
    d.add_argument("-o", "--output", default=None,
                   help="write the diff JSON here (default: stdout)")

    args = ap.parse_args(argv)
    if args.cmd == "diff":
        with open(args.a) as f:
            rep_a = json.load(f)
        with open(args.b) as f:
            rep_b = json.load(f)
        result = metric_diff(rep_a, rep_b, threshold=args.threshold)
        text = json.dumps(result, indent=2) + "\n"
        if args.output:
            with open(args.output, "w") as f:
                f.write(text)
        else:
            sys.stdout.write(text)
        return 0 if result["ok"] else 1
    rows = _load(args.logs, include_rotated=not args.no_rotated)
    if args.cmd == "summarize":
        print(json.dumps(summarize(rows, curve_points=args.curve_points)))
        return 0
    if args.cmd == "trace":
        text = trace_report(rows, stats=args.stats,
                            straggler_k=args.straggler_k)
    else:
        text = to_prometheus(summarize(rows), prefix=args.prefix)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


def trace_report(rows: List[dict], stats: bool = False,
                 straggler_k: float = 4.0) -> str:
    """The ``trace`` subcommand's engine: Chrome-trace JSON (default)
    or a postmortem stats report, from raw flight-recorder rows."""
    from ..observability import tracing

    recs = [r for r in rows if r.get("event") in ("span", "evt")]
    if not stats:
        return json.dumps(tracing.to_chrome_trace(recs)) + "\n"
    traces = tracing.stitch(recs)
    vals = [tracing.validate_trace(t["spans"]) for t in traces.values()]
    stage_stats: Dict[tuple, list] = {}
    for r in recs:
        if r.get("event") == "span" and "dur" in r:
            stage_stats.setdefault(
                (r.get("replica"), r["name"]), []
            ).append(float(r["dur"]))
    stragglers = tracing.detect_stragglers(stage_stats, k=straggler_k)
    report = {
        "traces": {
            "count": len(vals),
            "connected": sum(v["connected"] for v in vals),
            "with_orphans": sum(bool(v["orphans"]) for v in vals),
            "monotone": sum(v["monotone"] for v in vals),
        },
        "stages": tracing.stage_percentiles(recs),
        "stragglers": {
            str(rep): flags for rep, flags in sorted(
                stragglers.items(), key=lambda kv: str(kv[0])
            )
        },
    }
    return json.dumps(report, indent=2) + "\n"


if __name__ == "__main__":
    sys.exit(main())
