"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, the program
(``chainermn_tpu_torch``) and ``portbench/``.  It builds the cell's
program from ``--seed``, warms it up, measures ``--seconds``, with
``--trace 1`` profiles a few more steps, checks the first steps against
the plain reference, and prints one JSON line last on standard output
(the numbers compared, with their limits, also last on standard error).
It exits non-zero with no result without enough CUDA cards, without the
program, or if any process of the run loaded JAX.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from portbench import harness, trace  # noqa: E402

RUN_TIMEOUT_S = 330      # the spawned ranks' share of a run's 360 s


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def result(bench, workload, outs, trace_on, kind, chips):
    """The result line (printed last) from every rank's record."""
    r0 = outs[0]
    rec = {"chips": chips, "unit": r0["work"]["unit"],
           "setup_s": r0["setup_s"], "window": r0["window"],
           "work": r0["work"],
           "peak_bytes": max(o["peak_bytes"] for o in outs),
           "dispatch_s": r0.get("dispatch_s"),
           "counters": r0.get("counters"), "stretch": r0.get("stretch")}
    metrics = {}
    for m in bench.metrics(workload, trace_on):
        v = bench.metric_reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": rec["peak_bytes"]}
    out = {"correct": bool(r0["correct"]),
           "attempted": r0["window"]["steps"],
           "failed": r0["window"]["failed"], "metrics": metrics,
           "device": device}
    if trace_on:
        device["busy_s"] = sum(o["busy_s"] for o in outs) / len(outs)
        device["window_s"] = r0["stretch_wall_s"]
        out["breakdown"] = trace.breakdown(r0["stretch"])
    out["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                     for k, c in r0["checks"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = harness.Bench(ROOT)
    cell, _ = bench.cell(args.workload)
    chips = cell["chips"]
    harness.hygiene(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"{args.workload} needs {chips} CUDA card(s); this "
                    f"machine has {torch.cuda.device_count()}")
        return 3
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        harness.log(f"cards: {card[:chips]}")
    except (OSError, subprocess.SubprocessError) as e:
        harness.log(f"nvidia-smi unavailable: {e!r}")
    spec = {"root": ROOT, "workload": args.workload, "seed": args.seed,
            "seconds": args.seconds, "trace": args.trace, "rank": 0,
            "world": chips, "device": "cuda", "t_start": T_START}
    if chips == 1:
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            os.environ.pop(k, None)
        outs = [harness.run_rank(spec)]
    else:
        outs = harness.spawn(spec, chips, RUN_TIMEOUT_S,
                             os.path.join(ROOT, "portbench", "rank.py"))
    found = sorted(set(harness.forbidden_modules()).union(
        *(o["forbidden"] for o in outs)))
    if found:
        harness.log(f"modules that no run may load were loaded: {found}")
        return 4
    out = result(bench, args.workload, outs, bool(args.trace),
                 torch.cuda.get_device_name(0), chips)
    for name, c in out["checks"].items():
        harness.log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
